"""Hand-written CUDA kernels of the engine, of the LM serving path, of
the FM recsys path and of training (the attention and FM backwards), and
their plain versions.

Each wrapper runs its plain torch version on CPU tensors (and on meta
tensors, where a dry run computes shapes only; ``_build.runs_plain``)
and launches its CUDA kernel on CUDA tensors, counting launches in its
module's ``LAUNCHES``."""
from repro_torch.kernels import (
    flash_attention, fm_interaction, merge_probe, segment_reduce,
)

_COUNTS = (merge_probe.LAUNCHES, segment_reduce.LAUNCHES,
           flash_attention.LAUNCHES, fm_interaction.LAUNCHES)


def launch_counts() -> dict:
    """Kernel name -> launches since the last ``reset_launch_counts``."""
    return {k: v for counts in _COUNTS for k, v in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0
