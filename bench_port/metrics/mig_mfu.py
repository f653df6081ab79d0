"""The eval's share of the chip's peak: the work a MIG/AAM eval needs
(the encoder's forward over the lattice, and a fixed count per
log-density, whatever computes them) over the mean eval time, over the
configuration's peak."""

import roofline


def read(cell):
    if not cell.work.get("evals"):
        return None
    cfg = cell.config
    flops = roofline.mig_eval_flops(cfg["lat_sizes"], tuple(cfg["img_size"]),
                                    cfg["latent_dim"])
    return 100 * flops * cell.work["evals"] / cell.window_s \
        / cfg["peak_flops"]
