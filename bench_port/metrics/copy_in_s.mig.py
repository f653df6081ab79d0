"""Seconds an eval spends copying its streamed encode batches to the
device (the `eval.copy_in` span: a pageable host-to-device copy), mean
over the traced window's evals."""

import spans


def read(cell):
    return spans.per_unit(cell, "eval", "eval.copy_in", "evals")
