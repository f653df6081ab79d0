"""The training step's share of the chip's peak: the model's FLOPs per
image (forward, dgrad and wgrad; no conv1 dgrad) times the images trained
in the window, over the window, over the configuration's peak."""

import roofline


def read(cell):
    if not cell.work.get("images"):
        return None
    cfg = cell.config
    flops = roofline.train_flops_per_image(tuple(cfg["img_size"]),
                                           cfg["latent_dim"])
    return 100 * flops * cell.work["images"] / cell.window_s \
        / cfg["peak_flops"]
