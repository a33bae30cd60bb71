"""Write the evaluation protocol's annotation files.

Counterpart of ``scripts/make_eval_annotations.py``, byte for byte:

- ``CUFED5_pairs.txt``: 126 pairs ``{i:03d}_0.png {i:03d}_1.png`` (the
  CUFED5 input against its level-1 reference);
- ``WR-SR_pairs.txt``: 80 pairs ``{i:03d}.png {i:03d}_ref.png``;
- ``contras_val.txt``: the 22 pairs of the stage-1/2 validation split
  (fixed images at reference levels 1-5), with no newline after the last.

    python -m c2matching_tpu_torch.scripts.make_eval_annotations [out_dir]

``out_dir`` defaults to ./datasets.
"""
import os
import sys

# the stage-1/2 validation split: (image, ref_level) protocol constants
CONTRAS_VAL = [
    (4, 1), (7, 1), (52, 1), (102, 1), (109, 1),
    (21, 2), (68, 2), (91, 2),
    (19, 3), (45, 3),
    (1, 4), (101, 4),
    (0, 5),
    (12, 1), (15, 1), (95, 1),
    (37, 2), (105, 2),
    (26, 3), (48, 3),
    (5, 4),
    (125, 5),
]


def main(out_dir='./datasets'):
    os.makedirs(out_dir, exist_ok=True)

    with open(os.path.join(out_dir, 'CUFED5_pairs.txt'), 'w') as f:
        f.write('\n'.join(f'{i:03d}_0.png {i:03d}_1.png'
                          for i in range(126)) + '\n')

    with open(os.path.join(out_dir, 'WR-SR_pairs.txt'), 'w') as f:
        f.write('\n'.join(f'{i:03d}.png {i:03d}_ref.png'
                          for i in range(1, 81)) + '\n')

    with open(os.path.join(out_dir, 'contras_val.txt'), 'w') as f:
        f.write('\n'.join(f'{i:03d}_0.png {i:03d}_{lvl}.png'
                          for i, lvl in CONTRAS_VAL))

    print(f'wrote CUFED5_pairs.txt (126), WR-SR_pairs.txt (80), '
          f'contras_val.txt ({len(CONTRAS_VAL)}) to {out_dir}')


if __name__ == '__main__':
    main(*sys.argv[1:])
