"""Images trained in the window over the window's wall time (host
clock): whole epochs in one Trainer call, the last epoch's metrics fetch
inside."""


def read(cell):
    if "images" not in cell.work:
        return None
    return cell.work["images"] / cell.window_s
