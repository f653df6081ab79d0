"""Milliseconds an epoch's host waits for the copy of an epoch's metrics
(the `train.fetch` span: the device's queue draining to it), mean over
the traced window's epochs."""

import spans


def read(cell):
    seconds = spans.per_unit(cell, "train.epoch", "train.fetch", "epochs")
    return None if seconds is None else 1e3 * seconds
