"""Milliseconds an epoch spends enqueueing its resident super-steps and
tail (the `train.dispatch` span), mean over the traced window's
epochs."""

import spans


def read(cell):
    seconds = spans.per_unit(cell, "train.epoch", "train.dispatch", "epochs")
    return None if seconds is None else 1e3 * seconds
