"""The Evaluator's encode phase (`last_metrics_timings["encode_seconds"]`,
ended synchronised with the device), mean over the window's evals."""

import numpy as np


def read(cell):
    if not cell.timings:
        return None
    return float(np.mean([t["encode_seconds"] for t in cell.timings]))
