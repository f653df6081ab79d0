"""Device time per optimizer step: the union of the device's busy
intervals in the traced window over the steps trained in it."""


def read(cell):
    if cell.summary is None or not cell.summary["busy_s"] \
            or not cell.work.get("steps"):
        return None
    return 1e3 * cell.summary["busy_s"] / cell.work["steps"]
