"""The device's idle share of the traced training window."""

import idle


def read(cell):
    return idle.share(cell)
