"""The device's idle share of the traced MIG/AAM window."""

import idle


def read(cell):
    return idle.share(cell)
