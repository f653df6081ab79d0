"""The port's data parallelism across real processes on the CPU (gloo),
against the 1-process port and the JAX package.

Each run is W OS processes, every one a rank of a gloo group formed by
`parallel.distributed.initialize()` from the launcher's environment
(`tests/dp_worker.py`), or `torchrun` driving the CLI. Every rank and
every 1-process reference computes on one thread, so the only differences
left are the collectives' summation order and the per-rank batch shapes.

Tolerances:
* one DP step against the 1-process step at the global batch: metrics rel
  1e-5 and updated parameters atol 5e-6, the bounds of
  tests/test_train.py::test_sharded_step_matches_single_device, and each
  gradient Adam stepped with to max |d| / max |g| <= 1e-5 (the ranks sum
  their rows' contributions in another order). Adam's first step moves a
  parameter by lr * g / (|g| + eps), eps = 1e-8: where |g| < 1e-6 float
  noise in g moves it by up to a fraction of lr = 1e-3 (2.2e-4 seen for
  one betaH weight), so such a parameter is held through its gradient;
* the DP btcvae step against JAX's sharded step on the 8-device mesh, on
  JAX's own noise, the port-vs-JAX bounds of tests/test_torch_train.py:
  metrics rtol 1e-5 (atol 1e-6), parameters atol lr / 10;
* the CLI, as tests/test_multihost.py holds the JAX CLI: losses and
  parameters rel 1e-4, abs 1e-5; a resumed run equals a straight one bit
  for bit;
* the split Evaluator against the single-process one: 1e-6 (float64 sums
  over other sample groupings).
"""

from torch_threads import child_env  # first: the thread budget

import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from disvae_tpu.models.vae import init_specific_model as jax_init
from disvae_tpu.ops import losses as JL
from disvae_tpu.parallel.mesh import create_mesh as jax_mesh
from disvae_tpu.parallel.mesh import shard_batch as jax_shard
from disvae_tpu.train.state import create_train_state as jax_state
from disvae_tpu.train.steps import make_optimizer as jax_opt
from disvae_tpu.train.steps import make_train_step as jax_step

import dp_worker as W
from disvae_tpu_torch.train.steps import make_train_step
from disvae_tpu_torch.utils.torch_compat import from_jax_params, to_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "dp_worker.py")
TIMEOUT = 120  # seconds, per process wait


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(procs, **extra):
    """The environment of `procs` processes started at once."""
    env = child_env(procs, PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _communicate(procs):
    """Wait for every process (each within TIMEOUT); kill all on a
    timeout. Returns their outputs; asserts they all exited 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "process {} failed:\n{}".format(
            i, out[-4000:])
    return outs


def _launch(world, argv, cwd):
    """`world` ranks of `python tests/dp_worker.py argv...`, each given
    the launcher's environment."""
    port = str(_free_port())
    return _communicate([subprocess.Popen(
        [sys.executable, WORKER] + argv, cwd=cwd, env=_env(
            world, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
            MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)])


@pytest.fixture
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ----------------------------------------------------------------------
# one DP step per loss, at 2 and 4 ranks
# ----------------------------------------------------------------------

def _jax_btcvae(batch):
    """JAX's btcvae step on the 8-device mesh, and the noise it draws."""
    cfg = JL.get_loss_f("btcvae", **W.KWARGS)
    model, params = jax_init("Burgess", (1, 32, 32), 10,
                             key=jax.random.PRNGKey(0))
    state = jax_state(model, params, jax_opt(W.LR), jax.random.PRNGKey(1),
                      loss_cfg=cfg)
    _, sub = jax.random.split(state.rng)
    eps = np.asarray(jax.random.normal(sub, (batch.shape[0], 10)))
    mesh = jax_mesh()
    step = jax_step(model, cfg, jax_opt(W.LR), mesh=mesh, donate=False)
    new, metrics = step(state, jax_shard(batch, mesh))
    return params, eps, new, metrics


@pytest.fixture(scope="module", params=[2, 4], ids=["w2", "w4"])
def dp_steps(request, tmp_path_factory):
    world = request.param
    out = tmp_path_factory.mktemp("steps{}".format(world))
    argv = ["steps", str(out)]
    jax_run = None
    if world == 2:
        batch = W.step_batch(32)
        jax_run = _jax_btcvae(batch)
        torch.save({"weights": from_jax_params(jax.tree_util.tree_map(
            np.array, jax_run[0])), "batch": torch.from_numpy(batch),
            "eps": torch.from_numpy(np.array(jax_run[1]))}, out / "case.pt")
        argv.append(str(out / "case.pt"))
    _launch(world, argv, str(out))
    ranks = [torch.load(out / "steps-{}.pt".format(r)) for r in range(world)]
    return world, ranks, jax_run


@pytest.mark.parametrize("n", W.STEP_BATCHES, ids=["full", "ragged"])
@pytest.mark.parametrize("loss", W.LOSSES)
def test_dp_step_matches_one_process(dp_steps, one_thread, loss, n):
    world, ranks, _ = dp_steps
    cfg, state = W.make_state(loss)
    metrics = make_train_step(cfg)(state, torch.from_numpy(W.step_batch(n)))
    want = W.snapshot(state, metrics)
    got = ranks[0][(loss, n)]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-5), k
    for part in ("model", "disc"):
        for k, v in want.get(part, {}).items():
            g_want, g_got = want[part + "_grad"][k], got[part + "_grad"][k]
            err = (g_got - g_want).abs().max() / g_want.abs().max()
            assert err <= 1e-5, (part, k, float(err))
            stable = g_want.abs() >= 1e-6
            np.testing.assert_allclose(got[part][k][stable], v[stable],
                                       rtol=0, atol=5e-6,
                                       err_msg="{} {}".format(part, k))
    # every rank stepped its replica alike
    for other in ranks[1:]:
        for part in ("model", "disc"):
            for k, v in got.get(part, {}).items():
                assert torch.equal(other[(loss, n)][part][k], v), k


@pytest.mark.parametrize("dp_steps", [2], indirect=True, ids=["w2"])
def test_dp_btcvae_step_matches_jax_sharded_step(dp_steps):
    _, ranks, (_, _, j_new, j_metrics) = dp_steps
    got = ranks[0][("btcvae", "pinned")]
    assert set(got["metrics"]) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(got["metrics"][k], float(j_metrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    mine = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(
        got["model"])))
    theirs = dict(jax.tree_util.tree_leaves_with_path(j_new.params))
    assert set(mine) == set(theirs)
    for path, leaf in theirs.items():
        np.testing.assert_allclose(np.asarray(mine[path]), np.asarray(leaf),
                                   rtol=0, atol=W.LR / 10,
                                   err_msg=str(path))


# ----------------------------------------------------------------------
# the split Evaluator
# ----------------------------------------------------------------------

def test_split_evaluator_matches_single_process(tmp_path, one_thread):
    _launch(2, ["evaluate", str(tmp_path)], str(tmp_path))
    got = [torch.load(tmp_path / "evaluate-{}.pt".format(r))
           for r in range(2)]
    single = tmp_path / "single"
    os.makedirs(single)
    want = W.evaluate(None, str(single))
    for rank in got:
        np.testing.assert_allclose(rank["H_z"], want["H_z"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(rank["H_zCv"], want["H_zCv"], rtol=0,
                                   atol=1e-6)
        for k in ("MIG", "AAM"):
            assert rank["metrics"][k] == pytest.approx(want["metrics"][k],
                                                       abs=1e-6)
        assert rank["losses"] == pytest.approx(want["losses"], rel=1e-6)
    # the code carries information about the factors
    assert (want["H_z"][None] - want["H_zCv"]).max() > 0.1
    assert sorted(os.listdir(tmp_path / "evaluate-0")) == sorted(
        os.listdir(single)) == ["metric_helpers.pth", "metrics.log",
                                "test_losses.log"]
    assert os.listdir(tmp_path / "evaluate-1") == []


# ----------------------------------------------------------------------
# the CLI under torchrun, as tests/test_multihost.py drives the JAX CLI
# ----------------------------------------------------------------------

# 99 images at b16: a ragged tail of 3, which pads to 4 over 2 ranks
N_IMGS = 99
CLI_ARGS = ["run", "-d", "mnist", "-l", "betaH", "-b", "16",
            "--checkpoint-every", "1", "--no-progress-bar", "-s", "1234",
            "-L", "info", "--no-cuda", "--eval-batchsize", "50"]

# Installed through PYTHONPATH into every CLI process. It records each
# path the process opens for writing, creates or renames onto (every
# artifact is written to a tmp file and renamed), so the test can tell
# which rank wrote what. And it turns oneDNN off: at b16 its CPU weight
# gradient of the first decoder convT is 9.4e-3 (of the tensor's max) away
# from the float64 value on this run's first step, where the two ranks' b8
# halves land within 2e-7, so the 1-process reference itself would be the
# run that is off; without oneDNN both are within 2e-7.
SITE = """
import atexit, os, sys
import torch
torch.backends.mkldnn.enabled = False
_log, _dumping = [], []
def _hook(event, args):
    if _dumping:
        return
    if event == "open" and isinstance(args[0], (str, bytes)):
        mode, flags = args[1], args[2]
        if (mode and any(c in mode for c in "wax+")) or (
                not mode and flags & (os.O_WRONLY | os.O_RDWR)):
            _log.append(os.path.abspath(os.fsdecode(args[0])))
    elif event == "os.mkdir":
        _log.append(os.path.abspath(os.fsdecode(args[0])))
    elif event == "os.rename":  # os.replace too: torch.save's tmp files
        _log.append(os.path.abspath(os.fsdecode(args[1])))
def _dump():
    _dumping.append(1)
    name = "writes-{}-{}.txt".format(os.environ.get("RANK", "single"),
                                     os.getpid())
    with open(os.path.join(os.environ["AUDIT_DIR"], name), "w") as f:
        f.write("\\n".join(_log))
if os.environ.get("AUDIT_DIR"):
    sys.addaudithook(_hook)
    atexit.register(_dump)
"""


def _fabricate_mnist(root):
    d = os.path.join(root, "mnist")
    os.makedirs(d)
    rng = np.random.RandomState(0)
    ys, xs = np.mgrid[0:32, 0:32]
    imgs = np.zeros((N_IMGS, 32, 32, 1), np.uint8)
    for i in range(N_IMGS):
        cy, cx, r = rng.randint(8, 24), rng.randint(8, 24), rng.randint(3, 8)
        imgs[i, :, :, 0] = (((ys - cy) ** 2 + (xs - cx) ** 2) < r * r) * 255
    np.savez_compressed(os.path.join(d, "train32.npz"), imgs=imgs,
                        labels=rng.randint(0, 10, N_IMGS))


def _cli(site, cwd, extra, world=None):
    """The CLI in `cwd`: under torchrun with `world` ranks, or as one plain
    process. Returns its output."""
    os.makedirs(cwd, exist_ok=True)
    if world is None:
        cmd = [sys.executable, "-m", "disvae_tpu_torch"]
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", str(world), "--master_addr", "127.0.0.1",
               "--master_port", str(_free_port()), "-m", "disvae_tpu_torch"]
    env = _env(world or 1, PYTHONPATH=os.pathsep.join([site, REPO]),
               DISVAE_DATA_ROOT=os.path.join(site, "data"), AUDIT_DIR=cwd)
    out, = _communicate([subprocess.Popen(
        cmd + CLI_ARGS + extra, cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)])
    return out


def _writes(cwd, rank):
    """Paths under `cwd` that the processes of `rank` opened for writing
    or created."""
    out = []
    for name in os.listdir(cwd):
        if name.startswith("writes-{}-".format(rank)):
            with open(os.path.join(cwd, name)) as f:
                out += [p for p in f.read().split("\n")
                        if p.startswith(str(cwd) + os.sep)]
    return out


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two ranks for 1 epoch (then resumed for a 2nd), one plain process
    for 1 epoch, and two ranks for 2 epochs straight."""
    base = tmp_path_factory.mktemp("cli")
    site = str(base / "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(SITE)
    _fabricate_mnist(os.path.join(site, "data"))
    dirs = {k: base / k for k in ("resumed", "single", "straight")}
    logs = {"dp": _cli(site, dirs["resumed"], ["-e", "1"], 2)}
    # the 1-epoch artifacts, before the resumed run replaces them
    shutil.copytree(dirs["resumed"] / "results" / "run", base / "dp1")
    logs["single"] = _cli(site, dirs["single"], ["-e", "1"])
    _cli(site, dirs["resumed"], ["-e", "2", "--resume"], 2)
    _cli(site, dirs["straight"], ["-e", "2"], 2)
    return base, dirs, logs


def _read_log(path):
    rows = {}
    with open(path) as f:
        assert f.readline().strip() == "Epoch,Loss,Value"
        for line in f:
            e, k, v = line.strip().split(",")
            rows[(int(e), k)] = float(v)
    return rows


def test_cli_ranks_formed_a_two_rank_group(cli_runs):
    _, _, logs = cli_runs
    for rank in range(2):
        assert "Data-parallel mesh: rank {} of 2 (backend gloo)".format(
            rank) in logs["dp"], logs["dp"][-3000:]
    assert "Data-parallel mesh" not in logs["single"]


def test_cli_matches_one_process(cli_runs):
    """Step 1's row of train_losses.log within the JAX multihost bounds
    (rel 1e-4, abs 1e-5). The model and the test losses after the epoch's
    7 steps within the JAX package's bounds for a data-parallel run
    against one device (tests/test_train.py::
    test_mesh_trainer_ragged_multiepoch_equals_single_device: rel 1e-3,
    abs 1e-3 and atol 3e-3): each step's gradients agree to 1e-6 of their
    scale, but Adam's early steps turn that into parameter drift (1.4e-3
    here). The JAX multihost test holds its tighter bound to a run of the
    same 8-device program on both sides."""
    base, dirs, _ = cli_runs
    dp, single = base / "dp1", dirs["single"] / "results" / "run"
    got = _read_log(dp / "train_losses.log")
    want = _read_log(single / "train_losses.log")
    assert set(got) == set(want) and {e for e, _ in got} == {0}
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-5), k
    a, b = torch.load(dp / "model.pt"), torch.load(single / "model.pt")
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=3e-3,
                                   err_msg=k)
    with open(dp / "test_losses.log") as f, \
            open(single / "test_losses.log") as g:
        got, want = json.load(f), json.load(g)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-3, abs=1e-3), k


def test_cli_rank0_writes_every_artifact_once(cli_runs):
    base, dirs, _ = cli_runs
    run = dirs["straight"] / "results" / "run"
    for f in ("model.pt", "model-0.pt", "model-1.pt", "specs.json",
              "train_state.pt", "train_losses.log", "test_losses.log",
              "training.gif"):
        assert (run / f).exists(), f
    for cwd in dirs["straight"], dirs["resumed"]:
        assert _writes(cwd, 1) == [], cwd
    rank0 = _writes(dirs["straight"], 0)
    assert rank0.count(str(run / "test_losses.log") + ".tmp") == 1
    assert rank0.count(str(run / "model.pt")) == 1


def test_cli_resume_equals_straight_run(cli_runs):
    _, dirs, _ = cli_runs
    a = torch.load(dirs["straight"] / "results" / "run" / "model.pt")
    b = torch.load(dirs["resumed"] / "results" / "run" / "model.pt")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert _read_log(dirs["straight"] / "results" / "run"
                     / "train_losses.log") == _read_log(
        dirs["resumed"] / "results" / "run" / "train_losses.log")
