"""The device's idle share of a traced window: 1 - busy / window."""


def share(cell):
    if cell.summary is None or not cell.summary["busy_s"]:
        return None
    return 100 * (1 - cell.summary["busy_s"] / cell.window_s)
