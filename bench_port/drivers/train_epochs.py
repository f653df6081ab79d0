"""Training traffic: whole shuffled epochs through one `Trainer.__call__`,
as a training job runs them.

Traffic parameters: `min_epochs`, the window's least number of epochs,
and `epoch_s`, the seconds an epoch took in the window when the cell was
set (H100): the window trains E = max(`min_epochs`, round(seconds /
`epoch_s`)) epochs, a fixed amount of work for a given `--seconds`.

Set-up builds the program's Trainer once from the seed (weights, images,
its loader's shuffles and its noise seed). The checked steps go through
the window's own call, the Trainer's resident super-step of K steps: a
first call on K batches of rows warms it (eager), a second captures it
as a CUDA graph and replays it (on the card); then the weights, Adam's
moments and step counts, the loss's step and the noise generator are
set back in place to what the Trainer was built with, and a third call
replays the graph once on K other batches (no row twice): K steps from
the start, as the window's replays run them. It keeps what the check
compares. Then one warm epoch (it replays the same graph; the eager
short super-step and the ragged tail; the epoch-0 checkpoint). The
window trains its E epochs in one call, after epoch 0 as in a job, and
ends with the last epoch's metrics fetch.

The control builds the program's model in its lower compute dtype
(`lower_compute_dtype` of the configuration) and runs the same.

The check: the reference (plain PyTorch under the configuration's
numerics) follows the same K steps from the same weights, rows and
noise. Compared (`compare`; the cell's limits name what decides
`correct`): the first step's loss and each latent's KL, the parameters'
change after the K steps per leaf, and how many of the last step's
gradient elements bf16 holds exactly. Adam's state after one step, which
holds the first gradient, is not on the timed path: a replay runs K
steps at once.
"""

import logging

import numpy as np
import torch

import inputs
from reference import btcvae
from reference.model import param_spec
from reference.seeds import derive_seeds

QUIET = logging.getLogger("bench_port.program")
QUIET.setLevel(logging.WARNING)


def _dataset(cfg, imgs):
    """The program's dataset class of the configuration over `imgs`, the
    benchmark's images held in host memory."""
    from disvae_tpu_torch.data.datasets import BaseDataset, get_dataset

    class Images(get_dataset(cfg["dataset"])):
        def __init__(self):
            BaseDataset.__init__(self, imgs)
    return Images()


def build(cell):
    """The program's Trainer and loader, built from the seed, after its
    checked super-step. Returns (trainer, loader, what the check
    keeps)."""
    from disvae_tpu_torch.data.datasets import DataLoader
    from disvae_tpu_torch.models import burgess
    from disvae_tpu_torch.models.vae import VAE
    from disvae_tpu_torch.ops import convt_bwd
    from disvae_tpu_torch.ops.losses import get_loss_f
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.train.trainer import Trainer

    cfg, dev = cell.config, cell.device
    img_size = tuple(cfg["img_size"])
    s_weights, s_images, s_loader, s_trainer, s_rows = derive_seeds(
        cell.seed, 5)
    configure(cfg["precision"])
    burgess.set_final_convt_impl(
        convt_bwd.conv_transpose2d_pl if cfg["final_convt"] == "kernels"
        else burgess.conv_transpose2d)
    imgs = inputs.uint8_images(cfg["n_images"], img_size, s_images, dev)
    weights = inputs.vae_weights(img_size, cfg["latent_dim"], s_weights,
                                 dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    model = VAE(img_size, cfg["latent_dim"], cfg["model"],
                compute_dtype=(cfg["lower_compute_dtype"] if cell.control
                               else "float32")).to(dev)
    model.load_state_dict(weights)
    loader = DataLoader(_dataset(cfg, imgs), batch_size=cfg["batch_size"],
                        shuffle=True, seed=s_loader)
    loss_f = get_loss_f(cfg["loss"], n_data=cfg["n_images"], **cfg)
    trainer = Trainer(model, loss_f, lr=cfg["lr"], seed=s_trainer,
                      logger=QUIET, save_dir=cell.tmp,
                      is_progress_bar=False, resident="auto",
                      skip_tiny_tail=True)

    # the checked steps: one super-step through the Trainer's own call and
    # upload, warmed and captured on other rows first, then replayed from
    # the start
    K, B = trainer.steps_per_dispatch, cfg["batch_size"]
    warm_rows, rows = np.random.default_rng(s_rows).permutation(
        cfg["n_images"])[:2 * K * B].reshape(2, K, B)
    trainer._use_resident(loader)
    wire = trainer.resident_data.wire
    state = trainer.state
    for _ in range(2):
        trainer._resident_step(state, wire,
                               torch.from_numpy(warm_rows).to(dev))
    _restart(trainer, weights, derive_seeds(s_trainer, 2)[0])
    metrics = trainer._resident_step(state, wire,
                                     torch.from_numpy(rows).to(dev))
    loss_col = trainer.metric_keys.index("loss")
    adam = [state.optimizer.state[p] for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]
    host = lambda ts: {  # noqa: E731  (copies: the window trains on)
        n: t.detach().to("cpu", torch.float32, copy=True)
        for n, t in zip(names, ts)}
    kl_cols = [trainer.metric_keys.index("kl_loss_{}".format(d))
               for d in range(cfg["latent_dim"])]
    checked = {"losses": metrics[:, loss_col].tolist(),
               "kl_step1": metrics[0, kl_cols].cpu(),
               "m": host(a["exp_avg"] for a in adam),
               "last_grads": host(p.grad for p in model.parameters()),
               "change": host(p - weights[n]
                              for n, p in model.named_parameters()),
               "rows": imgs[rows.reshape(-1)].copy(),
               "train_seed": s_trainer, "weights_seed": s_weights}
    return trainer, loader, checked


@torch.no_grad()
def _restart(trainer, weights, noise_seed):
    """Set the Trainer's state back, in place, to what it was built with:
    the weights, Adam's moments and step counts at zero (as before its
    first step), the loss's step and the noise generator's seed."""
    state = trainer.state
    for n, p in state.model.named_parameters():
        p.copy_(weights[n])
    for s in state.optimizer.state.values():
        for v in s.values():
            v.zero_()
    state.device_step.zero_()
    state.step = 0
    state.generator.manual_seed(noise_seed)


def setup(cell):
    trainer, loader, checked = build(cell)
    # the warm epoch: epoch 0 of the job
    trainer(loader, epochs=1,
            checkpoint_every=cell.config["checkpoint_every"])
    epochs = max(cell.traffic["min_epochs"],
                 round(cell.seconds / cell.traffic["epoch_s"]))
    return {"trainer": trainer, "loader": loader, "epochs": epochs,
            "checked": checked}


def _now(dev):
    import time
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def window(cell, state):
    trainer, loader, epochs = state["trainer"], state["loader"], \
        state["epochs"]
    n = len(loader.dataset)
    B = loader.batch_size
    steps0 = trainer.state.step
    # epochs 1..E of the job: the Trainer counts from where a resumed run
    # would start
    trainer._start_epoch = 1
    t0 = _now(cell.device)
    trainer(loader, epochs=1 + epochs,
            checkpoint_every=cell.config["checkpoint_every"])
    cell.window_s = _now(cell.device) - t0
    steps = trainer.state.step - steps0
    cell.work.update(attempted=steps, steps=steps, epochs=epochs,
                     images=epochs * n,
                     batches={B: epochs * (n // B)}
                     | ({n % B: epochs} if n % B > 1 else {}))


def release(cell, state):
    return state["checked"]


def reference(cell, kept, half=False):
    """The reference's steps from the checked steps' weights, rows and
    noise, under the configuration's numerics (btcvae.train_steps' dict,
    with "change" the parameters' change). `half`: the fault of a step
    that leaves out half of each batch and takes the mean over the
    rest."""
    cfg, dev = cell.config, cell.device
    img_size = tuple(cfg["img_size"])
    B, D = cfg["batch_size"], cfg["latent_dim"]
    weights = inputs.vae_weights(img_size, D, kept["weights_seed"], dev)
    gen = inputs.generator(dev, derive_seeds(kept["train_seed"], 2)[0])
    x = torch.from_numpy(kept["rows"]).to(dev).float() / 255.0
    batches = list(x.split(B))
    noises = [torch.randn((B, D), generator=gen, device=dev)
              for _ in batches]
    if half:
        batches = [b[:B // 2] for b in batches]
        noises = [n[:B // 2] for n in noises]
    ref = btcvae.train_steps(weights, batches, noises, cfg,
                             cfg["reference_numerics"])
    ref["change"] = {k: ref["params"][k] - weights[k] for k in weights}
    return {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
                else v.cpu() if torch.is_tensor(v) else v)
            for k, v in ref.items()}


def leaf_gaps(cell, got, ref):
    """Each step's relative loss gap, and each leaf's gap of the norms of
    Adam's first moment and of the parameters' change (the change over
    the leaves the reference moves)."""
    spec = param_spec(tuple(cell.config["img_size"]),
                      cell.config["latent_dim"])
    moving = _moving(ref["first_grads"], spec)
    return {"loss": [abs(a - b) / abs(b) for a, b in
                     zip(got["losses"], ref["losses"])],
            "m": _leaf_gaps(_norms(got["m"]), _norms(ref["m"])),
            "change": _leaf_gaps(_norms(got["change"]),
                                 _norms(ref["change"]), moving)}


def compare(cell, got, ref):
    """The numbers the check reads: the first step's relative loss gap
    (`loss_gap_step1`) and its worst latent's relative KL gap
    (`kl_gap_step1`); the worst moving leaf's gap of the norms of the
    parameters' change after the super-step (`change_gap`); the gap
    between the shares of the last step's gradient elements that bf16
    holds exactly (`grad_bf16_gap`: float32 sums leave almost none, a
    bf16 store almost all); and the median leaf's gap of the norms of
    Adam's first moment (`m_gap_median`), which the limits leave out
    (PERF.md)."""
    spec = param_spec(tuple(cell.config["img_size"]),
                      cell.config["latent_dim"])
    moving = _moving(ref["first_grads"], spec)
    gaps = leaf_gaps(cell, got, ref)
    kl_ref = ref["kl_step1"].double()
    return {"loss_gap_step1": gaps["loss"][0],
            "kl_gap_step1": float(((got["kl_step1"].double() - kl_ref).abs()
                                   / kl_ref.abs()).max()),
            "change_gap": max(gaps["change"].values()),
            "grad_bf16_gap": abs(_bf16_share(got["last_grads"], moving)
                                 - _bf16_share(ref["last_grads"], moving)),
            "m_gap_median": float(np.median(list(gaps["m"].values())))}


def check(cell, kept):
    """The program's checked steps (the control's, in a control run)
    against the reference's."""
    return compare(cell, kept, reference(cell, kept))


def _norms(tensors):
    return {n: float(t.norm()) for n, t in tensors.items()}


def _moving(ref_grads, spec):
    """Leaves whose reference first gradient's norm is at least a
    thousandth of the median leaf's: the others move under Adam by
    round-off alone."""
    norms = _norms(ref_grads)
    median = float(np.median(list(norms.values())))
    return [n for n, _, _ in spec if norms[n] >= 1e-3 * median]


def _leaf_gaps(got, ref, names=None):
    """{leaf: |got - ref| / max(ref, the median leaf's ref)}."""
    names = list(ref) if names is None else names
    median = float(np.median([ref[n] for n in names]))
    return {n: abs(got[n] - ref[n]) / max(ref[n], median) for n in names}


def _bf16_share(tensors, names):
    """The share of the nonzero float32 elements of `names` that bf16
    holds exactly (the low 16 bits of each are 0)."""
    bits = torch.cat([tensors[n].flatten() for n in names]).view(
        torch.int32)
    nonzero = (bits & 0x7FFFFFFF) != 0
    return float(((bits & 0xFFFF) == 0)[nonzero].double().mean())
