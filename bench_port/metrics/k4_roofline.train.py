"""K4 (thin_conv_dw, the encoder's conv1 weight gradient) against its
bound: the bound of every execution in the traced window over the device
time of K4's kernels (band and merge) there. conv1's operands, dy (B, 32,
H/2, W/2) and x (B, C, H, W) in bf16, are K1's x and dy at every batch
size, so K1's byte count is K4's."""

import convt_roofline
import roofline


def read(cell):
    return convt_roofline.share(cell, ("thin_conv_dw",), "thin_conv_dw_band",
                                roofline.k1_bound_s)
