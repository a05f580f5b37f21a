"""Hand-written CUDA kernels of the engine and their plain versions.

Each wrapper runs its plain torch version on CPU tensors and launches
its CUDA kernel on CUDA tensors, counting launches in its module's
``LAUNCHES``."""
from repro_torch.kernels import merge_probe, segment_reduce


def launch_counts() -> dict:
    """Kernel name -> launches since the last ``reset_launch_counts``."""
    return {**merge_probe.LAUNCHES, **segment_reduce.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (merge_probe.LAUNCHES, segment_reduce.LAUNCHES):
        for k in counts:
            counts[k] = 0
