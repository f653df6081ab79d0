"""The Evaluator's entropy sweeps (`last_metrics_timings[
"entropy_seconds"]`), mean over the window's evals."""

import numpy as np


def read(cell):
    if not cell.timings:
        return None
    return float(np.mean([t["entropy_seconds"] for t in cell.timings]))
