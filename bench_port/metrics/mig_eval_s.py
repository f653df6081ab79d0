"""Wall time of one MIG/AAM eval: the window's time over the whole evals
completed in it (host clock)."""


def read(cell):
    if not cell.work.get("evals"):
        return None
    return cell.window_s / cell.work["evals"]
