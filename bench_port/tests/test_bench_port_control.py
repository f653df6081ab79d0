"""On the card, at each cell's own size, through a whole run
(`harness.run_cell`): the control (the program's lower-precision path in
its place) comes out not correct, a sound run correct, and so does a
training run whose graph replays the indices it was captured with.
Needs a CUDA device; skips without one.

    python -m pytest bench_port/tests/test_bench_port_control.py -q
"""

import os

import pytest
import torch

from tiny import ROOT, restore_program

import harness

CELLS = ["celeba_train", "dsprites_mig", "dsprites_mig_fast"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    restore_program()


def _run(cell, seed, device, control=False):
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    if cell not in {w["name"] for w in bench["workloads"]}:
        pytest.skip("{} is not a cell of BENCHMARK.json".format(cell))
    return harness.run_cell(bench, cell, seed, 2.0, False, device, ROOT,
                            control)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cuda, cell):
    result, checks = _run(cell, 2 ** 31 + 101, cuda, control=True)
    assert not result["correct"], checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_on_the_card(cuda, cell):
    result, checks = _run(cell, 2 ** 31 + 102, cuda)
    assert result["correct"], checks


@pytest.mark.gpu
def test_a_replay_of_stale_indices_is_not_correct(cuda, monkeypatch):
    """The graphed super-step replays without copying in its call's
    indices: the eager and captured steps are sound, the replays not."""
    from disvae_tpu_torch.train import steps

    def call(self, state, data, idx):
        key = (state, data, tuple(idx.shape))
        if idx.shape[0] != self.k:
            return self.multi(state, data, idx)
        if not steps._same(self._captured, key):
            if not steps._same(self._warm, key):
                self._warm = key
                return self.multi(state, data, idx)
            self._capture(state, data, idx)
        self._graph.replay()
        state.step += self.k
        for p, g in self._grads:
            p.grad = g
        return self._out.clone()
    monkeypatch.setattr(steps.GraphedSuperStep, "__call__", call)
    result, checks = _run("celeba_train", 2 ** 31 + 103, cuda)
    assert not result["correct"], checks
