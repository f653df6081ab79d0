"""Each cell's check, driven through a whole run on the CPU at a small
size (the harness's look for a chip skipped): a sound run comes out
correct, and a run whose timed path is broken underneath comes out not
correct, for each fault the cell can have. The cells run on one chip, so
no exchange between chips can be left out.

    python -m pytest bench_port/tests -q
"""

import pytest
import torch

from tiny import restore_program, tiny_root

import harness


def _run(tmp_path, cell, seed=11):
    root, bench = tiny_root(tmp_path)
    try:
        result, checks = harness.run_cell(bench, cell, seed, 0.2, False,
                                          torch.device("cpu"), root=root)
    finally:
        restore_program()
    return result, checks


def _state_unchanged(monkeypatch):
    """Every optimizer step leaves the parameters as they were."""
    orig = torch.optim.Adam.step

    def step(self, *args, **kwargs):
        params = [p for g in self.param_groups for p in g["params"]]
        saved = [p.detach().clone() for p in params]
        out = orig(self, *args, **kwargs)
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
        return out
    monkeypatch.setattr(torch.optim.Adam, "step", step)


def _half_batch(monkeypatch):
    """The loss of each step over the first half of its batch only."""
    from disvae_tpu_torch.ops.losses import BtcvaeLoss
    orig = BtcvaeLoss.__call__

    def call(self, data, recon, latent_dist, is_train, step,
             latent_sample=None, **kwargs):
        h = data.shape[0] // 2
        return orig(self, data[:h], recon[:h],
                    tuple(t[:h] for t in latent_dist), is_train, step,
                    latent_sample=latent_sample[:h], **kwargs)
    monkeypatch.setattr(BtcvaeLoss, "__call__", call)


def _loss_altered(monkeypatch):
    """Each step's reported loss 1% off where the step produces it."""
    from disvae_tpu_torch.train import steps
    orig = steps.stack_metrics

    def stack(metrics, key_order):
        metrics = dict(metrics, loss=metrics["loss"] * 1.01)
        return orig(metrics, key_order)
    monkeypatch.setattr(steps, "stack_metrics", stack)


def _entropies_altered(monkeypatch):
    from disvae_tpu_torch.train.evaluate import Evaluator
    orig = Evaluator._estimate_latent_entropies
    monkeypatch.setattr(Evaluator, "_estimate_latent_entropies",
                        lambda self, *a, **k: orig(self, *a, **k) + 1e-2)


def _half_samples(monkeypatch):
    """Each entropy sweep averaged over the first half of its samples."""
    from disvae_tpu_torch.train.evaluate import Evaluator
    orig = Evaluator._entropy_sweep
    monkeypatch.setattr(
        Evaluator, "_entropy_sweep",
        lambda self, values, mu, logvar, M, S: orig(
            self, values[:, :, :S // 2], mu, logvar, M, S // 2))


def _encode_altered(monkeypatch):
    """The encoder's mu 1e-3 of its scale off where it is produced."""
    from disvae_tpu_torch.models.vae import VAE
    orig = VAE.encode

    def encode(self, x):
        mu, logvar = orig(self, x)
        return mu + 1e-3 * mu.abs().max(), logvar
    monkeypatch.setattr(VAE, "encode", encode)


FAULTS = {
    "celeba_train": [_state_unchanged, _half_batch, _loss_altered],
    "dsprites_mig": [_entropies_altered, _half_samples, _encode_altered],
    "dsprites_mig_fast": [_entropies_altered, _half_samples,
                          _encode_altered],
}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_a_sound_run_is_correct(tmp_path, cell):
    result, checks = _run(tmp_path, cell)
    assert result["correct"], checks


@pytest.mark.parametrize("cell, fault", [(c, f) for c, fs in FAULTS.items()
                                         for f in fs],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            fault):
    fault(monkeypatch)
    result, checks = _run(tmp_path, cell)
    assert not result["correct"], checks
