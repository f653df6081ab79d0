"""K2 (convt3_dx, the final convT's input gradient, float32 dx) against
its bound: the bound of every execution in the traced window over the
device time of K2's kernel there."""

import convt_roofline
import roofline


def read(cell):
    return convt_roofline.share(cell, ("convt3_dx",), "convt3_dx",
                                roofline.k2_bound_s)
