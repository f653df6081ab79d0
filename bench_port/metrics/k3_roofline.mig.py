"""K3 (log_qz) against its bound: the operations bound of the launches of
every eval in the traced window (the exps split between the SFU and the
FMA pipe) over the device time of K3's kernels (peak, partial, merge,
recompute) there. None where the window launched no K3."""

import roofline
from devtrace import kernel_time


def read(cell):
    if cell.summary is None or not cell.work.get("evals"):
        return None
    seconds, _ = kernel_time(cell.summary, "log_qz_")
    if not seconds:
        return None
    cfg = cell.config
    bound = cell.work["evals"] * roofline.k3_bound_s(cfg["lat_sizes"],
                                                     cfg["latent_dim"])
    return 100 * bound / seconds
