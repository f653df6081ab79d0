"""Seconds an eval spends copying each entropy sweep chunk's sums to the
host (the `eval.sweep_fetch` span; it waits for the chunk's device work),
mean over the traced window's evals."""

import spans


def read(cell):
    return spans.per_unit(cell, "eval", "eval.sweep_fetch", "evals")
