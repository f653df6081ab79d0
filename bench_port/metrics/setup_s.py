"""Set-up: process start to the first timed step (host clock)."""


def read(cell):
    return cell.setup_s
