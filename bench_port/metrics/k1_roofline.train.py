"""K1 (convt3_dw, the final convT's weight gradient) against its bound:
the bound of every execution in the traced window (bytes over the
memory rate, at each step's batch size) over the device time of K1's
kernels (band and merge) there."""

import convt_roofline
import roofline


def read(cell):
    return convt_roofline.share(cell, ("convt3_dw",), "convt3_dw_band",
                                roofline.k1_bound_s)
