"""A copy of the benchmark at a size the CPU runs in seconds, for the
tests: the same files, with the configurations' data cut down."""

import json
import os
import shutil
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(TESTS)
ROOT = os.path.dirname(BENCH_DIR)
for path in (BENCH_DIR, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

# what each file's keys become in the copy
CUTS = {
    # the checked super-step and its warm-up take 2 x 16 batches of rows
    # that all differ
    "configs/btcvae_celeba.json": {"n_images": 300, "batch_size": 8},
    "configs/btcvae_dsprites.json": {"lat_sizes": [3, 2, 2, 4, 4],
                                     "eval_batchsize": 50},
    # the --fast-metrics estimator's entropy error at the copy's 192-image
    # lattice is about 2e-4, twenty times its error at the full lattice,
    # where the limit is set: the copy's limit sits above that and below
    # its faults' readings
    "limits/dsprites_mig_fast.json": {"entropy_gap": 1e-3},
}


def tiny_root(dest):
    """Copy BENCHMARK.json and the benchmark's folder under `dest` with
    CUTS applied. Returns (root, the benchmark's dict)."""
    root = str(dest)
    shutil.copytree(BENCH_DIR, os.path.join(root, "bench_port"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for rel, cut in CUTS.items():
        path = os.path.join(root, "bench_port", rel)
        with open(path) as f:
            data = json.load(f)
        data.update(cut)
        with open(path, "w") as f:
            json.dump(data, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return root, json.load(f)


def restore_program():
    """Undo what a run sets process-wide in the program: the precision
    policy and the final convT's implementation."""
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.ops.precision import configure
    configure("highest")
    burgess.set_final_convt_impl(burgess.conv_transpose2d)
