"""The readers of the program's spans (`spans.py`, the `program_span`
metrics that read its tally): None without the enclosing phase, 0 without
the span, the per-eval or per-epoch mean otherwise, nothing from a program
without spans; and, in a traced run of each cell at a small size on the
CPU, a number that nests inside its phase.

    python -m pytest bench_port/tests -q
"""

import sys
import types

import pytest
import torch

from tiny import restore_program, tiny_root

import harness
import spans
from disvae_tpu_torch.utils import trace

# metric: (phase, span, the work it is counted over, scale)
READERS = {
    "feed_s.mig": ("eval", "eval.feed", "evals", 1.0),
    "copy_in_s.mig": ("eval", "eval.copy_in", "evals", 1.0),
    "draw_s.mig": ("eval", "eval.draw", "evals", 1.0),
    "sweep_fetch_s.mig": ("eval", "eval.sweep_fetch", "evals", 1.0),
    "dispatch_ms.train": ("train.epoch", "train.dispatch", "epochs", 1e3),
    "fetch_wait_ms.train": ("train.epoch", "train.fetch", "epochs", 1e3),
}


def _read(metric, work, tally):
    trace.reset()
    trace._TALLY.update({k: list(v) for k, v in tally.items()})
    try:
        reader = harness.load_module(
            "{}/metrics/{}.py".format(harness.BENCH_DIR, metric),
            "test_metric_" + metric.replace(".", "_"))
        return reader.read(types.SimpleNamespace(work=work))
    finally:
        trace.reset()


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader(metric):
    phase, name, unit, scale = READERS[metric]
    both = {phase: (4, 9.0), name: (17, 2.0)}
    assert _read(metric, {unit: 4}, both) == pytest.approx(scale * 0.5)
    assert _read(metric, {unit: 4}, {phase: (4, 9.0)}) == 0.0
    assert _read(metric, {unit: 4}, {name: (17, 2.0)}) is None
    assert _read(metric, {unit: 0}, both) is None
    assert _read(metric, {}, both) is None
    # a tally that holds more phases than the window ran is not this
    # window's
    assert _read(metric, {unit: 3}, both) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "disvae_tpu_torch.utils.trace", None)
    assert spans.tally() is None
    cell = types.SimpleNamespace(work={"evals": 2})
    assert spans.per_unit(cell, "eval", "eval.feed", "evals") is None


@pytest.mark.parametrize("cell", ["dsprites_mig", "dsprites_mig_fast",
                                  "celeba_train"])
def test_a_traced_run_reads_every_span_metric(tmp_path, cell):
    root, bench = tiny_root(tmp_path)
    trace.reset()
    try:
        result, checks = harness.run_cell(bench, cell, 11, 0.2, True,
                                          torch.device("cpu"), root=root)
    finally:
        restore_program()
        trace.reset()
    assert result["correct"], checks
    got = {k: v["value"] for k, v in result["metrics"].items()}
    mine = [m for m in READERS
            if cell in next(e for e in bench["per_layer"]
                            if e["name"] == m)["workloads"]]
    assert mine and all(got[m] >= 0 for m in mine)
    if cell.startswith("dsprites"):
        assert got["feed_s.mig"] > 0 and got["copy_in_s.mig"] > 0
        assert got["feed_s.mig"] + got["copy_in_s.mig"] \
            <= got["encode_s.mig"]
        assert got["draw_s.mig"] + got["sweep_fetch_s.mig"] \
            <= got["entropy_s.mig"]
    else:
        assert got["dispatch_ms.train"] > 0 and got["fetch_wait_ms.train"] > 0
