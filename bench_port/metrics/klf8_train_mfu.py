"""The klf8 training step's share of the chip's peak: the model's FLOPs
per image (roofline_klf8.py, frozen from shapes) times the images trained
in the window, over the window, over the configuration's peak."""

import roofline_klf8


def read(cell):
    if not cell.work.get("images"):
        return None
    cfg = cell.config
    arch = {k: cfg[k] for k in roofline_klf8.PUBLISHED if k in cfg}
    flops = roofline_klf8.train_flops_per_image(tuple(cfg["img_size"]),
                                                **arch)
    return 100 * flops * cell.work["images"] / cell.window_s \
        / cfg["peak_flops"]
