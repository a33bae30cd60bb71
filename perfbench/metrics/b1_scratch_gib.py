"""Kernel B1's device scratch, in GiB: the program's counter
``match_argmax.scratch_bytes``, the largest scratch one call of the
operator allocated in the run's process (for f32 operands their TF32
split, two f32 copies of q and of r; past one partition, the
partitions' values and indices), read after the window. Nothing where
the program keeps no such counter or launched no kernel.
"""
import importlib


def read(run, variant):
    match_argmax = importlib.import_module(
        'c2matching_tpu_torch.ops.patch_match_kernel').match_argmax
    nbytes = getattr(match_argmax, 'scratch_bytes', None)
    if nbytes is None or not match_argmax.launches:
        return None
    return nbytes / 2 ** 30
