"""Device milliseconds per step in GroupNorm's forward and backward
kernels (PyTorch's native group norm: its moments, fused parameters and
elementwise passes, whose names hold the `GroupNorm...Internal` function
that launches them, and its backward's gradient kernels), over the traced
window's steps. The names are those an eager step's kernels carry under
`aten::native_group_norm` and its backward on the H100
(klf8_kernels.py)."""

from devtrace import kernel_time

KERNELS = ("GroupNorm", "RowwiseMoments", "ComputeFusedParams",
           "ComputeInternalGradients", "ComputeBackwardFusedParams",
           "GammaBetaBackward")


def read(cell):
    if cell.summary is None or not cell.work.get("steps"):
        return None
    seconds, _ = kernel_time(cell.summary, *KERNELS)
    return 1e3 * seconds / cell.work["steps"] if seconds else None
