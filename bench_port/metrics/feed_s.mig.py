"""Seconds an eval spends making its streamed encode batches on the host
(the `eval.feed` span: the loader's gather and bit-packing), mean over
the traced window's evals; 0 for a resident feed."""

import spans


def read(cell):
    return spans.per_unit(cell, "eval", "eval.feed", "evals")
