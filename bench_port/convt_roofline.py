"""A K1/K2 roofline share from a traced training window: each step runs
one execution at its batch size, so the bound is the sum over the
window's steps; the device time is that of the kernel's launches by name.
None when the trace holds none, or other than one execution a step."""

from devtrace import kernel_time


def share(cell, kernel_parts, execution_part, bound_of):
    if cell.summary is None or "batches" not in cell.work:
        return None
    seconds, _ = kernel_time(cell.summary, *kernel_parts)
    _, executions = kernel_time(cell.summary, execution_part)
    batches = cell.work["batches"]
    if not seconds or executions != sum(batches.values()):
        return None
    img_size = tuple(cell.config["img_size"])
    bound = sum(n * bound_of(b, img_size) for b, n in batches.items())
    return 100 * bound / seconds
