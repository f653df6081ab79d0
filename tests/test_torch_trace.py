"""The port's spans (disvae_tpu_torch/utils/trace.py): silent without a
profiler, `disvae::` host events nested as the code nests them under one,
and where the Evaluator and the Trainer put them: one span per streamed
batch, per sweep chunk and per epoch, with the phases timing what
`last_metrics_timings` times. Nothing the program reports changes under
the profiler."""

import torch_threads  # noqa: F401  (first: the thread budget)

import contextlib
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from disvae_tpu_torch.data import datasets as PD
from disvae_tpu_torch.models.vae import init_specific_model
from disvae_tpu_torch.ops import convt_bwd, log_qz
from disvae_tpu_torch.ops import losses as PL
from disvae_tpu_torch.train import evaluate
from disvae_tpu_torch.train.evaluate import Evaluator
from disvae_tpu_torch.utils import trace
from disvae_tpu_torch.utils.trace import span

from test_torch_evaluate import LAT_NAMES, LAT_SIZES, _lattice_images
from test_torch_train import KWARGS, _dataset, _trainer

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_port")


@pytest.fixture(autouse=True)
def _empty_tally():
    trace.reset()
    yield
    trace.reset()


def _torch_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _bench_profile():
    """The benchmark's traced window: the profiler's low-level enable."""
    sys.path.insert(0, BENCH_DIR)
    try:
        from devtrace import Profile
    finally:
        sys.path.remove(BENCH_DIR)
    return Profile(torch.device("cpu"))


def _ranges(recorder):
    """{name: [(start_ns, end_ns)]} of the `disvae::` host events."""
    events = (recorder.events if isinstance(recorder.events, list)
              else recorder.profiler.kineto_results.events())
    out = {}
    for e in events:
        if e.name().startswith(trace.PREFIX):
            out.setdefault(e.name()[len(trace.PREFIX):], []).append(
                (e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def test_no_profiler_leaves_the_tally_empty():
    with span("outer"):
        with span("inner"):
            torch.ones(3).sum()
    assert trace.tally() == {}


@pytest.mark.parametrize("recorder", [_torch_profile, _bench_profile],
                         ids=["torch.profiler", "bench_port.devtrace"])
def test_nested_spans_are_host_events_inside_their_parent(recorder):
    with recorder() as prof:
        with span("outer"):
            for _ in range(3):
                with span("inner"):
                    torch.ones(64).sum()
    ranges = _ranges(prof)
    (o0, o1), = ranges["outer"]
    assert len(ranges["inner"]) == 3
    assert all(o0 <= a <= b <= o1 for a, b in ranges["inner"])
    tally = trace.tally()
    assert tally["outer"][0] == 1 and tally["inner"][0] == 3
    assert 0 < tally["inner"][1] <= tally["outer"][1]
    assert tally["outer"][1] <= (o1 - o0) * 1e-9


@pytest.mark.parametrize("straddles", ["start", "stop"])
def test_a_span_takes_the_profilers_state_at_its_entry(straddles):
    """Entered before the profiler starts: nothing, though it exits under
    it. Entered under it: recorded whole, though it exits after."""
    s = span("straddle")
    if straddles == "start":
        s.__enter__()
        with _torch_profile():
            s.__exit__(None, None, None)
        assert trace.tally() == {}
    else:
        with _torch_profile():
            s.__enter__()
        s.__exit__(None, None, None)
        assert trace.tally()["straddle"][0] == 1


def _evaluator_run(tmp_path, resident):
    imgs = _lattice_images() * 255
    loader = PD.DataLoader(PD.ArrayDataset(imgs, lat_sizes=LAT_SIZES,
                                           lat_names=LAT_NAMES),
                           batch_size=10)
    model = init_specific_model("Burgess", (1, 64, 64), 4,
                                generator=torch.Generator().manual_seed(0))
    loss_f = PL.get_loss_f("btcvae", rec_dist="bernoulli", reg_anneal=0,
                           btcvae_A=1, btcvae_B=6, btcvae_G=1,
                           n_data=len(imgs))
    ev = Evaluator(model, loss_f, save_dir=str(tmp_path), metrics_seed=7,
                   resident=resident)
    ev(loader, is_metrics=True, is_losses=False)
    return ev, loader


@pytest.mark.parametrize("resident", ["never", "always"])
def test_evaluator_spans(tmp_path, monkeypatch, resident):
    # sweep chunks of 5 samples: the marginal sweep's 24 take 5 chunks,
    # factor k's 24 / |v_k| samples take 2, 2 and 3
    monkeypatch.setattr(evaluate, "_SAMPLE_CHUNK", 5)
    with _torch_profile() as prof:
        ev, loader = _evaluator_run(tmp_path, resident)
    tally = trace.tally()
    calls = {k: v[0] for k, v in tally.items()}
    streamed = len(loader) if resident == "never" else 0
    assert calls.get("eval.feed", 0) == calls.get("eval.copy_in", 0) \
        == streamed == (3 if resident == "never" else 0)
    assert calls["eval"] == calls["eval.encode"] == calls["eval.entropy"] \
        == 1
    assert calls["eval.sweep_fetch"] == 5 + 2 + 2 + 3
    # the marginal draw, and each factor's gather plan and draws
    assert calls["eval.draw"] == 1 + 2 * len(LAT_SIZES)
    timings = ev.last_metrics_timings
    for name, key in (("eval.encode", "encode_seconds"),
                      ("eval.entropy", "entropy_seconds")):
        assert abs(tally[name][1] - timings[key]) <= max(
            0.05 * timings[key], 2e-3), name
    ranges = _ranges(prof)
    (e0, e1), = ranges["eval"]
    for phase in ("eval.encode", "eval.entropy"):
        (p0, p1), = ranges[phase]
        assert e0 <= p0 <= p1 <= e1
    (n0, n1), = ranges["eval.entropy"]
    for name in ("eval.draw", "eval.sweep_fetch"):
        assert all(n0 <= a <= b <= n1 for a, b in ranges[name])
    (c0, c1), = ranges["eval.encode"]
    for name in ("eval.feed", "eval.copy_in"):
        assert all(c0 <= a <= b <= c1 for a, b in ranges.get(name, []))


def test_trainer_spans(tmp_path):
    """90 rows at batch 32, two steps a super-step: an epoch is one whole
    super-step and the 26-row tail."""
    cfg = PL.get_loss_f("btcvae", **dict(KWARGS, n_data=90, reg_anneal=20))
    tr = _trainer(tmp_path, cfg, resident="always", steps_per_dispatch=2)
    with _torch_profile() as prof:
        tr(PD.DataLoader(_dataset(90), batch_size=32, shuffle=True, seed=0),
           epochs=2, checkpoint_every=1)
    calls = {k: v[0] for k, v in trace.tally().items()}
    assert calls["train.epoch"] == calls["train.fetch"] == 2
    assert calls["train.dispatch"] >= 1
    assert calls["train.replay"] == calls["train.eager"] \
        == calls["train.checkpoint"] == 2
    ranges = _ranges(prof)
    for (d0, d1), (e0, e1) in zip(ranges["train.dispatch"],
                                  ranges["train.epoch"]):
        assert e0 <= d0 <= d1 <= e1
    for a, b in ranges["train.replay"] + ranges["train.eager"]:
        assert any(d0 <= a <= b <= d1 for d0, d1 in ranges["train.dispatch"])


def _counters():
    return (log_qz.log_qz.launches, convt_bwd.convt3_dw.launches,
            convt_bwd.convt3_dw.captured, convt_bwd.convt3_dx.launches,
            convt_bwd.convt3_dx.captured)


@pytest.mark.parametrize("part", ["evaluator", "trainer"])
def test_what_the_program_reports_is_the_same_under_the_profiler(
        tmp_path, part):
    seen = {}
    for profiled in (False, True):
        save = tmp_path / str(profiled)
        save.mkdir()
        before = _counters()
        with (_torch_profile() if profiled else contextlib.nullcontext()):
            if part == "evaluator":
                ev, _ = _evaluator_run(save, "never")
                keys = sorted(ev.last_metrics_timings)
                out = ev.last_metrics_internals["cond_entropies"]
            else:
                cfg = PL.get_loss_f("VAE", **KWARGS)
                tr = _trainer(save, cfg, resident="always")
                tr(PD.DataLoader(_dataset(64), batch_size=16, shuffle=True,
                                 seed=0), epochs=2, checkpoint_every=10)
                keys = [sorted(e) for e in tr.epoch_stats]
                out = np.array([e["loss"] for e in tr.epoch_stats])
        launched = tuple(b - a for a, b in zip(before, _counters()))
        seen[profiled] = (keys, out, launched)
    assert seen[True][0] == seen[False][0]
    np.testing.assert_array_equal(seen[True][1], seen[False][1])
    assert seen[True][2] == seen[False][2]
