"""Tensor parallelism of the FactorVAE discriminator in the port, on the
CPU over gloo, against the 1-process port and the JAX package.

Each multi-rank run is W OS processes (`tests/dp_worker.py tp`), or
`torchrun` driving the CLI, laid out as (W / M data) x (M model) ranks:
(W, M) = (2, 2), (4, 2) and (4, 4). At M = 2 all six discriminator layers
are split, lin6 (1000 -> 2) included; at M = 4 lin6 stays whole. Every
rank and every 1-process reference computes on one thread.

Tolerances:
* one TP FactorVAE step against the 1-process step at the global batch,
  the data-parallel bounds of tests/test_torch_multiproc.py: metrics rel
  1e-5, parameters atol 5e-6 where the gradient is at least 1e-6, each
  gradient max |d| / max |g| <= 1e-5;
* against JAX's `make_tp_train_step` on the 8-device mesh (4 data x 2
  model), on JAX's own noise, the port-vs-JAX bounds of
  tests/test_torch_train.py: metrics rtol 1e-5 (atol 1e-6), parameters
  atol lr / 10;
* a TP CLI run resumed at another M against a straight run: its log
  (first epoch, the same M) bit for bit, the final model within the bounds
  tests/test_torch_multiproc.py::test_cli_matches_one_process holds a
  data-parallel CLI run to against one process (losses rel 1e-3, abs
  1e-3; parameters atol 3e-3), since another M sums the latent's
  gradient over another number of shards and feeds other per-rank batch
  shapes.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from disvae_tpu.models.discriminator import Discriminator as JaxDisc
from disvae_tpu.models.vae import init_specific_model as jax_init
from disvae_tpu.ops import losses as JL
from disvae_tpu.parallel.mesh import create_mesh as jax_mesh
from disvae_tpu.parallel.mesh import make_tp_train_step as jax_tp_step
from disvae_tpu.parallel.mesh import shard_batch as jax_shard
from disvae_tpu.parallel.mesh import tp_state_shardings
from disvae_tpu.train.state import create_train_state as jax_state
from disvae_tpu.train.steps import _factor_train_step as jax_factor_step
from disvae_tpu.train.steps import make_disc_optimizer as jax_disc_opt
from disvae_tpu.train.steps import make_optimizer as jax_opt

import dp_worker as W
from disvae_tpu_torch.models.discriminator import Discriminator
from disvae_tpu_torch.parallel.mesh import Mesh, tp_param_shards
from disvae_tpu_torch.train.steps import make_train_step
from disvae_tpu_torch.utils.torch_compat import (disc_from_jax_params,
                                                 disc_to_jax_params,
                                                 from_jax_params,
                                                 to_jax_params)
from test_torch_multiproc import (REPO, SITE, _communicate, _env,
                                  _fabricate_mnist, _free_port, _launch,
                                  _read_log, one_thread)  # noqa: F401

LAYOUTS = [(2, 2), (4, 2), (4, 4)]
JAX_BATCH = 32
# output units of lin1 ... lin6
DISC_OUT = [1000] * 5 + [2]


def _split_layers(m):
    """The layers JAX's rule splits at model size m."""
    return ["lin{}".format(i) for i, out in enumerate(DISC_OUT, 1)
            if out % m == 0]


def _jax_tp_case():
    """JAX's FactorVAE step with the discriminator 2-way column-parallel
    on the 4 x 2 mesh (tests/test_train.py::
    test_tensor_parallel_factor_step_on_mesh), and what the port needs to
    take the same step: the weights, the batch and the noise JAX draws."""
    cfg = JL.get_loss_f("factor", **W.KWARGS)
    disc, d_opt = JaxDisc(latent_dim=10), jax_disc_opt(cfg)
    model, params = jax_init("Burgess", (1, 32, 32), 10,
                             key=jax.random.PRNGKey(0))
    state = jax_state(model, params, jax_opt(W.LR), jax.random.PRNGKey(1),
                      disc=disc, disc_optimizer=d_opt,
                      disc_rng=jax.random.PRNGKey(2), loss_cfg=cfg)
    batch = W.step_batch(JAX_BATCH)
    _, sub = jax.random.split(state.rng)
    r1, r2, rp = jax.random.split(sub, 3)
    h = JAX_BATCH // 2
    noise = {"eps1": jax.random.normal(r1, (h, 10)),
             "eps2": jax.random.normal(r2, (h, 10)),
             "perm": jax.numpy.argsort(jax.random.uniform(rp, (h, 10)),
                                       axis=0)}
    mesh = jax_mesh(model_parallel=2)
    step = jax_tp_step(lambda s, b: jax_factor_step(model, cfg, jax_opt(W.LR),
                                                    disc, d_opt, s, b),
                       mesh, state, donate=False)
    new, metrics = step(state, jax_shard(batch, mesh))
    case = {"weights": from_jax_params(jax.tree_util.tree_map(np.array,
                                                              params)),
            "disc": disc_from_jax_params(jax.tree_util.tree_map(
                np.array, state.disc_params)),
            "batch": torch.from_numpy(batch),
            "noise": {k: torch.from_numpy(np.array(v)).to(
                torch.long if k == "perm" else torch.float32)
                for k, v in noise.items()}}
    return case, new, metrics


@pytest.fixture(scope="module", params=LAYOUTS,
                ids=["w{}m{}".format(*p) for p in LAYOUTS])
def tp_runs(request, tmp_path_factory):
    world, m = request.param
    out = tmp_path_factory.mktemp("tp{}{}".format(world, m))
    argv = ["tp", str(out), str(m)]
    jax_run = None
    if (world, m) == (4, 2):
        case, *jax_run = _jax_tp_case()
        torch.save(case, out / "case.pt")
        argv.append(str(out / "case.pt"))
    _launch(world, argv, str(out))
    ranks = [torch.load(out / "tp-{}.pt".format(r)) for r in range(world)]
    return world, m, ranks, jax_run


def test_ranks_lay_out_as_jax_reshape(tp_runs):
    """Rank r is data rank r // M and model rank r % M (JAX's
    `reshape(n // M, M)`); M = 2 splits all six layers, M = 4 all but
    lin6."""
    world, m, ranks, _ = tp_runs
    for r, got in enumerate(ranks):
        assert got["layout"] == (r // m, world // m, r % m, m)
        assert got["split"] == _split_layers(m)


def _check_against_one_process(ranks, m, n):
    """Rank results of one TP FactorVAE step on `step_batch(n)` against
    the 1-process step at the global batch; every rank ends with the same
    whole state."""
    cfg, state = W.make_state("factor")
    metrics = make_train_step(cfg)(state, torch.from_numpy(W.step_batch(n)))
    want = W.snapshot(state, metrics)
    for r, rank in enumerate(ranks):
        got = rank[n]
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-5), k
        for part in ("model", "disc"):
            for k, v in want[part].items():
                g_want = want[part + "_grad"][k]
                g_got = got[part + "_grad"][k]
                if g_got.shape != g_want.shape:  # this rank's shard rows
                    rows = g_got.shape[0]
                    g_want = g_want[(r % m) * rows:(r % m + 1) * rows]
                err = (g_got - g_want).abs().max() / g_want.abs().max()
                assert err <= 1e-5, (part, k, float(err))
                stable = want[part + "_grad"][k].abs() >= 1e-6
                np.testing.assert_allclose(got[part][k][stable], v[stable],
                                           rtol=0, atol=5e-6,
                                           err_msg="{} {}".format(part, k))
        for part in ("model", "disc"):
            for k, v in ranks[0][n][part].items():
                assert torch.equal(got[part][k], v), (r, part, k)


@pytest.mark.parametrize("n", W.STEP_BATCHES, ids=["full", "ragged"])
def test_tp_step_matches_one_process(tp_runs, one_thread, n):
    """One TP FactorVAE step (the ragged batch padded to the data axis
    where it does not divide it) against the 1-process step."""
    _, m, ranks, _ = tp_runs
    _check_against_one_process(ranks, m, n)


@pytest.mark.parametrize("tp_runs", [(4, 2)], indirect=True, ids=["w4m2"])
def test_tp_padded_255_of_256_matches_one_process(tp_runs, one_thread):
    """255 real rows padded to 256 over the 2-rank data axis (the padded
    mask-aware step) against the 1-process step on the 255."""
    _, m, ranks, _ = tp_runs
    _check_against_one_process(ranks, m, 255)


@pytest.mark.parametrize("tp_runs", [(4, 2)], indirect=True, ids=["w4m2"])
def test_tp_step_matches_jax_tp_step(tp_runs):
    _, _, ranks, (j_new, j_metrics) = tp_runs
    got = ranks[0]["pinned"]
    assert set(got["metrics"]) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(got["metrics"][k], float(j_metrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    pairs = [(to_jax_params(got["model"]), j_new.params),
             (disc_to_jax_params(got["disc"]), j_new.disc_params)]
    for mine, theirs in pairs:
        mine = dict(jax.tree_util.tree_leaves_with_path(mine))
        theirs = dict(jax.tree_util.tree_leaves_with_path(theirs))
        assert set(mine) == set(theirs)
        for path, leaf in theirs.items():
            np.testing.assert_allclose(np.asarray(mine[path]),
                                       np.asarray(leaf), rtol=0,
                                       atol=W.LR / 10, err_msg=str(path))


@pytest.mark.parametrize("m", [2, 3, 4, 8])
def test_tp_param_shards_match_jax(m):
    """The port splits the layers JAX's tp_state_shardings splits: a
    weight whose output units divide M goes column-parallel (the torch
    weight's rows), biases stay replicated."""
    cfg = JL.get_loss_f("factor", **W.KWARGS)
    disc = JaxDisc(latent_dim=10)
    model, params = jax_init("Burgess", (1, 32, 32), 10,
                             key=jax.random.PRNGKey(0))
    state = jax_state(model, params, jax_opt(W.LR), jax.random.PRNGKey(1),
                      disc=disc, disc_optimizer=jax_disc_opt(cfg),
                      disc_rng=jax.random.PRNGKey(2), loss_cfg=cfg)
    mesh = jax_mesh(n_devices=8 // m * m, model_parallel=m)
    shardings = tp_state_shardings(mesh, state).disc_params
    want = {}
    for layer, leaves in shardings.items():
        for leaf, torch_name in (("w", "weight"), ("b", "bias")):
            spec = tuple(leaves[leaf].spec)
            want["{}.{}".format(layer, torch_name)] = (
                0 if spec == (None, "model") else None)
            assert spec in ((None, "model"), ())
    got = tp_param_shards(Mesh(rank=0, size=m, model_size=m),
                          Discriminator(latent_dim=10))
    assert got == want
    assert sorted(k for k, v in got.items() if v == 0) == [
        k + ".weight" for k in _split_layers(m)]


# ----------------------------------------------------------------------
# the CLI under torchrun: a TP run resumed at another M
# ----------------------------------------------------------------------

# FactorVAE doubles -b 16 to 32 and -e to twice as many epochs: 99 images
# give 4 steps an epoch, the last padded where 3 rows do not divide 2
TP_ARGS = ["run", "-d", "mnist", "-l", "factor", "-b", "16",
           "--checkpoint-every", "1", "--no-progress-bar", "-s", "1234",
           "-L", "info", "--no-cuda", "--eval-batchsize", "50",
           "--no-viz-gif"]


def _torchrun(site, cwd, world, extra):
    os.makedirs(cwd, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(world), "--master_addr", "127.0.0.1", "--master_port",
           str(_free_port()), "-m", "disvae_tpu_torch"]
    env = _env(PYTHONPATH=os.pathsep.join([site, REPO]),
               DISVAE_DATA_ROOT=os.path.join(site, "data"))
    out, = _communicate([subprocess.Popen(
        cmd + TP_ARGS + extra, cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)])
    return out


@pytest.fixture(scope="module")
def tp_cli(tmp_path_factory):
    """Four ranks: M = 2 for 2 epochs, then resumed at M = 4 for 2 more;
    and M = 2 for 4 epochs straight."""
    base = tmp_path_factory.mktemp("tpcli")
    site = str(base / "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(SITE)
    _fabricate_mnist(os.path.join(site, "data"))
    logs = {"first": _torchrun(site, base / "resumed", 4,
                               ["-e", "1", "--model-parallel", "2"])}
    run = base / "resumed" / "results" / "run"
    shutil.copy(run / "train_state.pt", base / "first_state.pt")
    logs["resumed"] = _torchrun(site, base / "resumed", 4,
                                ["-e", "2", "--model-parallel", "4",
                                 "--resume"])
    logs["straight"] = _torchrun(site, base / "straight", 4,
                                 ["-e", "2", "--model-parallel", "2"])
    return base, logs


def test_tp_cli_checkpoint_holds_the_whole_discriminator(tp_cli):
    base, logs = tp_cli
    assert "Tensor-parallel discriminator: 2 data x 2 model" in logs["first"]
    assert "Tensor-parallel discriminator: 1 data x 4 model" in \
        logs["resumed"]
    state = torch.load(base / "first_state.pt")["state"]
    whole = Discriminator(latent_dim=10).state_dict()
    assert {k: v.shape for k, v in state["disc"].items()} == \
        {k: v.shape for k, v in whole.items()}
    moments = state["disc_optimizer"]["state"]
    for i, k in enumerate(whole):
        assert moments[i]["exp_avg"].shape == whole[k].shape, k
        assert moments[i]["exp_avg_sq"].shape == whole[k].shape, k


def test_tp_cli_resumed_at_another_m_equals_straight_run(tp_cli):
    """The log (recorded at step 1 only: 4 steps an epoch) bit for bit,
    the final model and the test losses within the bounds above."""
    base, _ = tp_cli
    runs = [base / d / "results" / "run" for d in ("resumed", "straight")]
    assert _read_log(runs[0] / "train_losses.log") == \
        _read_log(runs[1] / "train_losses.log")
    a, b = (torch.load(r / "model.pt") for r in runs)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=3e-3, err_msg=k)
    got, want = (json.loads((r / "test_losses.log").read_text())
                 for r in runs)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-3, abs=1e-3), k
    for r in runs:
        assert sorted(os.listdir(r)) == ["model-0.pt", "model-1.pt",
                                         "model-2.pt", "model-3.pt",
                                         "model.pt", "specs.json",
                                         "test_losses.log",
                                         "train_losses.log",
                                         "train_state.pt"]
