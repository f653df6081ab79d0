"""Seconds an eval spends drawing the entropy sweeps' samples on the host
and uploading them with each factor's gather plan (the `eval.draw`
span), mean over the traced window's evals."""

import spans


def read(cell):
    return spans.per_unit(cell, "eval", "eval.draw", "evals")
