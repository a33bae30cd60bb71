"""Faults planted in the package under test, to show that ``correct``
catches them: each breaks the timed path underneath the entry points.

- 'answer_altered': the restoration net's output shifted where it is
  produced;
- 'half_batch': the second half of every fed batch replaced by the first
  half (its answers wrong; a loss the mean over half the batch);
- 'state_unchanged': every optimizer step skipped (the schedule counts
  still advance).

The benchmark's own runs plant none; the tests and the calibration's
readings of the faults do.
"""
import contextlib

import torch

NAMES = ('answer_altered', 'half_batch', 'state_unchanged')


@contextlib.contextmanager
def planted(name):
    from c2matching_tpu_torch.models import base_model
    from c2matching_tpu_torch.models import ref_restoration_model as rrm
    from c2matching_tpu_torch.models.archs import ref_restoration_arch as arch
    if name == 'answer_altered':
        owner, attr = arch.RestorationNet, 'forward'
        forward = owner.forward

        def patched(self, *args, **kwargs):
            out = forward(self, *args, **kwargs)
            return out + 0.05 * (out.detach().abs().amax() + 1)
    elif name == 'half_batch':
        owner, attr = rrm.RefRestorationModel, 'feed_data'
        feed = owner.feed_data

        def patched(self, batch):
            feed(self, batch)
            b = self.batch['img_in_lq'].shape[0]
            keep = max(1, b // 2)
            self.batch = {k: torch.cat([v[:keep]] * (b // keep + 1))[:b]
                          for k, v in self.batch.items()}
    elif name == 'state_unchanged':
        owner, attr = base_model.ScheduleCounts, 'step'

        def patched(self, which):
            self.counts[which] += 1
    else:
        raise ValueError(f'unknown fault {name!r}; known: {NAMES}')
    saved = owner.__dict__[attr]
    setattr(owner, attr, patched)
    try:
        yield
    finally:
        setattr(owner, attr, saved)
