"""One rank of a CPU data-parallel run of the port over gloo, and the cases
that tests/test_torch_multiproc.py and tests/test_torch_parallel.py share.

Imports torch and the port only (never jax), so each rank starts fast.
Run as a launcher would run it, with RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT in the environment:

    python tests/dp_worker.py steps <out_dir> [<case.pt>]
    python tests/dp_worker.py evaluate <out_dir>
    python tests/dp_worker.py tp <out_dir> <model_parallel> [<case.pt>]

`steps`: one data-parallel train step per loss from the seeded state of
`make_state`, on the full global batch of `step_batch(16)` and on the
ragged `step_batch(15)` (padded to the data axis), plus, when a case file
is given (torch.save of {"weights", "batch", "eps"}), one btcvae step from
those weights on that batch and pinned noise. `evaluate`: the
split Evaluator on `lattice()` with `eval_model()`. `tp`: on a mesh of
`model_parallel` ranks per model group, one FactorVAE step with the
discriminator column-parallel (`make_tp_train_step`) on each of the
`STEP_BATCHES` (and on 255 rows, padded to 256, where the data axis is 2
or more), plus, given a case file (torch.save of {"weights",
"disc", "batch", "noise"}), one from those weights on that batch and
pinned noise; each rank records its place in the layout. Each rank saves
its results to `<out_dir>/<job>-<rank>.pt`.
"""

import os
import sys
from datetime import timedelta

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from disvae_tpu_torch.data.datasets import ArrayDataset, DataLoader  # noqa: E402
from disvae_tpu_torch.models.discriminator import Discriminator  # noqa: E402
from disvae_tpu_torch.models.vae import init_specific_model  # noqa: E402
from disvae_tpu_torch.ops import losses as PL  # noqa: E402
from disvae_tpu_torch.train.state import create_train_state  # noqa: E402
from disvae_tpu_torch.train.steps import (make_disc_optimizer,  # noqa: E402
                                          make_optimizer)

LR = 1e-3
KWARGS = dict(rec_dist="bernoulli", reg_anneal=0, betaH_B=4, betaB_initC=0,
              betaB_finC=25, betaB_G=100, btcvae_A=1, btcvae_B=6,
              btcvae_G=1, n_data=100, latent_dim=10, factor_G=6,
              lr_disc=5e-5)
LOSSES = ["VAE", "betaH", "betaB", "btcvae", "factor"]
STEP_BATCHES = [16, 15]  # full, and ragged: padded to the data axis
LAT_SIZES, LAT_NAMES = (3, 4, 2), ("a", "b", "c")


def make_state(loss, img_size=(1, 32, 32)):
    """The seeded train state every rank, and the 1-process reference,
    starts from."""
    cfg = PL.get_loss_f(loss, **KWARGS)
    model = init_specific_model("Burgess", img_size, 10,
                                generator=torch.Generator().manual_seed(0))
    disc = disc_opt = None
    if cfg.needs_discriminator:
        disc = Discriminator(latent_dim=10,
                             generator=torch.Generator().manual_seed(2))
        disc_opt = make_disc_optimizer(disc.parameters(), cfg)
    state = create_train_state(model, make_optimizer(model.parameters(), LR),
                               torch.Generator().manual_seed(1), disc=disc,
                               disc_optimizer=disc_opt, loss_cfg=cfg)
    return cfg, state


def step_batch(n):
    return (np.random.RandomState(0).rand(n, 32, 32, 1) * 255).astype(
        np.uint8)


def snapshot(state, metrics):
    """What a step left: metrics, and every parameter and the gradient
    Adam stepped with, as host tensors."""
    out = {"metrics": {k: float(v) for k, v in metrics.items()}}
    for part in ("model", "disc"):
        module = getattr(state, part)
        if module is not None:
            out[part] = {k: v.detach().clone()
                         for k, v in module.named_parameters()}
            out[part + "_grad"] = {k: v.grad.clone()
                                   for k, v in module.named_parameters()}
    return out


def lattice():
    """Binary 32x32 images on the full (3, 4, 2) factor lattice, stored as
    0/255 intensities; each factor value owns a seeded random blob."""
    rng = np.random.RandomState(0)
    blobs = [rng.rand(n, 32, 32) > 0.8 for n in LAT_SIZES]
    imgs = np.zeros(LAT_SIZES + (32, 32), bool)
    for i in range(LAT_SIZES[0]):
        for j in range(LAT_SIZES[1]):
            for k in range(LAT_SIZES[2]):
                imgs[i, j, k] = blobs[0][i] | blobs[1][j] | blobs[2][k]
    imgs = imgs.reshape(-1, 32, 32, 1).astype(np.uint8) * 255
    return ArrayDataset(imgs, lat_sizes=LAT_SIZES, lat_names=LAT_NAMES)


def eval_model():
    """A seeded model whose posteriors are tight (logvar bias -6 at the odd
    head outputs), so its code carries information about the factors."""
    model = init_specific_model("Burgess", (1, 32, 32), 4,
                                generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        model.encoder.mu_logvar_gen.bias[1::2] -= 6.0
    return model


def evaluate(mesh, save_dir):
    from disvae_tpu_torch.train.evaluate import Evaluator
    ev = Evaluator(eval_model(), PL.get_loss_f("btcvae", **dict(
        KWARGS, n_data=24)), save_dir=save_dir, metrics_seed=7, mesh=mesh)
    # eval batch 5: the ranks' shares of the 24 rows end mid-batch
    metrics, losses = ev(DataLoader(lattice(), batch_size=5),
                         is_metrics=True, is_losses=True)
    helpers = ev.last_metrics_internals
    return {"metrics": metrics, "losses": losses,
            "H_z": torch.from_numpy(helpers["marginal_entropies"]),
            "H_zCv": torch.from_numpy(helpers["cond_entropies"])}


def run_steps(mesh, case_file):
    from disvae_tpu_torch.parallel.mesh import pad_to_multiple, shard_batch
    from disvae_tpu_torch.train.steps import (make_padded_train_step,
                                              make_train_step)
    out = {}
    for loss in LOSSES:
        for n in STEP_BATCHES:
            cfg, state = make_state(loss)
            padded, true_n = pad_to_multiple(step_batch(n), mesh.size)
            local = torch.from_numpy(shard_batch(padded, mesh))
            if len(padded) == true_n:
                metrics = make_train_step(cfg, mesh)(state, local)
            else:
                metrics = make_padded_train_step(cfg, mesh)(state, local,
                                                            true_n)
            out[(loss, n)] = snapshot(state, metrics)
    if case_file:
        case = torch.load(case_file)
        cfg, state = make_state("btcvae")
        state.model.load_state_dict(case["weights"])
        local = shard_batch(case["batch"], mesh)
        metrics = make_train_step(cfg, mesh)(state, local,
                                             {"eps": case["eps"]})
        out[("btcvae", "pinned")] = snapshot(state, metrics)
    return out


def tp_snapshot(state, metrics):
    """What a tensor-parallel step left: metrics, the VAE's parameters and
    gradients, the WHOLE discriminator (gathered over the model group) and
    this rank's shard gradients."""
    out = snapshot(state, metrics)
    out["disc"] = {k: v.clone() for k, v in state.state_dict()["disc"].items()}
    return out


def run_tp(mesh, case_file):
    from functools import partial

    from disvae_tpu_torch.parallel.mesh import (ColumnParallelLinear,
                                                make_tp_train_step,
                                                pad_to_multiple,
                                                shard_batch)
    from disvae_tpu_torch.train.steps import _factor_train_step
    out = {"layout": (mesh.data_rank, mesh.data_size, mesh.model_rank,
                      mesh.model_size)}
    # 255 real rows padded to 256 where the data axis is 2 or more
    for n in STEP_BATCHES + ([255] if mesh.data_size > 1 else []):
        cfg, state = make_state("factor")
        step = make_tp_train_step(partial(_factor_train_step, cfg), mesh,
                                  state)
        padded, true_n = pad_to_multiple(step_batch(n), mesh.data_size)
        local = torch.from_numpy(shard_batch(padded, mesh))
        out["split"] = sorted(name for name, m in state.disc.named_modules()
                              if isinstance(m, ColumnParallelLinear))
        n_valid = None if len(padded) == true_n else true_n
        out[n] = tp_snapshot(state, step(state, local, n_valid=n_valid))
    if case_file:
        case = torch.load(case_file)
        cfg, state = make_state("factor")
        state.model.load_state_dict(case["weights"])
        state.disc.load_state_dict(case["disc"])
        step = make_tp_train_step(partial(_factor_train_step, cfg), mesh,
                                  state)
        local = torch.from_numpy(shard_batch(case["batch"].numpy(), mesh))
        out["pinned"] = tp_snapshot(state, step(state, local, case["noise"]))
    return out


def main(job, out_dir, *extra):
    from disvae_tpu_torch.parallel import distributed
    from disvae_tpu_torch.parallel.mesh import create_mesh
    torch.set_num_threads(1)  # the 1-process reference runs on one too
    distributed.initialize(cuda=False, timeout=timedelta(seconds=60))
    if job == "tp":
        mesh = create_mesh(model_parallel=int(extra[0]))
        result = run_tp(mesh, extra[1] if len(extra) > 1 else None)
    elif job == "steps":
        mesh = create_mesh()
        result = run_steps(mesh, extra[0] if extra else None)
    else:
        mesh = create_mesh()
        save_dir = os.path.join(out_dir, "evaluate-{}".format(mesh.rank))
        os.makedirs(save_dir)
        result = evaluate(mesh, save_dir)
    torch.save(result, os.path.join(out_dir, "{}-{}.pt".format(
        job, mesh.rank)))
    distributed.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
