"""Training traffic inside an epoch: whole super-steps of the Trainer's
resident step, back to back, as the middle of a job's epoch runs them.

Traffic parameters: `min_supersteps`, the window's least number of
super-steps, and `superstep_s`, the seconds a super-step took in the
window when the cell was set (H100): the window runs S = max(
`min_supersteps`, round(seconds / `superstep_s`)) super-steps, a fixed
amount of work for a given `--seconds`.

Set-up builds the program's Trainer from the seed (weights drawn as the
reference draws them, images, the loader's shuffle, the noise seed) and
its resident upload. The checked steps go through the window's own call,
the Trainer's resident super-step: a call on the first checked batch
alone runs one eager step from the seeded weights (its gradients are
kept); then, as drivers/train_epochs.py runs them, a call on K other
batches of rows warms the K-step super-step (eager), a second
captures it as a CUDA graph and replays it (on the card); the weights,
Adam's moments and step counts, the loss's step and the noise generator
are set back to what the Trainer was built with, and a third call replays
the graph once on K other batches (no row twice). Then one more
super-step warms the window's rows. The window replays the super-step S
times, each under the Trainer's `train.replay` span as its epoch
dispatch runs it, over consecutive K x B chunks of the loader's epoch
order (no row twice), and ends with the fetch of their metrics.

The control builds the program's model in its lower compute dtype
(`lower_compute_dtype`) and runs the same.

The check: the plain reference (reference/autoencoder_kl.py, under the
configuration's numerics) follows the same K steps from the same
weights, rows and noise. Compared (PERF.md section 2 has the readings
the limits were set from): the first step's loss and KL term, relative
(`loss_gap_step1`, `kl_gap_step1`); each moving leaf's first-step
gradient against the reference's, both at the seeded weights on the
first batch and its noise, the norm of their difference over the
reference's norm, the worst leaf (`grad_gap`); the gap between the
shares of those gradients' nonzero elements that bf16 holds exactly
(`grad_bf16_gap`); and the gap of the norms of the parameters' change
after the K steps, all moving leaves together (`change_gap`: Adam's
steps part the two paths from step 2 on, leaf by leaf). The program's
first-step gradient comes from a one-batch call of the same resident
step before the capture: the eager step that a replay's first step
equals bit for bit (tests/test_torch_gpu.py); a replay leaves only its
last step's gradients.

A program without AutoencoderKL fails when this module is loaded.
"""

import logging
import time

import numpy as np
import torch

import inputs
from reference import autoencoder_kl as plain
from reference.seeds import derive_seeds

from disvae_tpu_torch.models import autoencoder_kl  # noqa: F401

QUIET = logging.getLogger("bench_port.program")
QUIET.setLevel(logging.WARNING)


def _dataset(cfg, imgs):
    from disvae_tpu_torch.data.datasets import BaseDataset, get_dataset

    class Images(get_dataset(cfg["dataset"])):
        def __init__(self):
            BaseDataset.__init__(self, imgs)
    return Images()


def _now(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@torch.no_grad()
def _restart(trainer, weights, noise_seed):
    """The Trainer's state set back in place to what it was built with."""
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
    from disvae_tpu_torch.data.datasets import DataLoader
    from disvae_tpu_torch.models.vae import VAE
    from disvae_tpu_torch.ops.losses import get_loss_f
    from disvae_tpu_torch.ops.precision import configure
    from disvae_tpu_torch.train.trainer import Trainer

    cfg, dev = cell.config, cell.device
    img_size = tuple(cfg["img_size"])
    arch = plain.architecture(cfg)
    s_weights, s_images, s_loader, s_trainer, s_rows = derive_seeds(
        cell.seed, 5)
    configure(cfg["precision"])
    imgs = inputs.uint8_images(cfg["n_images"], img_size, s_images, dev)
    weights = plain.init_params(img_size, s_weights, dev, arch)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = VAE(img_size, cfg["latent_dim"], cfg["model"],
                compute_dtype=(cfg["lower_compute_dtype"] if cell.control
                               else "float32"), **arch).to(dev)
    model.load_state_dict(weights)
    B, K = cfg["batch_size"], cfg["steps_per_dispatch"]
    loader = DataLoader(_dataset(cfg, imgs), batch_size=B, shuffle=True,
                        seed=s_loader)
    loss_f = get_loss_f(cfg["loss"], n_data=cfg["n_images"], **cfg)
    trainer = Trainer(model, loss_f, lr=cfg["lr"], seed=s_trainer,
                      logger=QUIET, save_dir=cell.tmp,
                      is_progress_bar=False, steps_per_dispatch=K,
                      resident="always", skip_tiny_tail=True)
    trainer._use_resident(loader)
    wire, state = trainer.resident_data.wire, trainer.state

    # the checked steps: the first step's gradients from a one-batch call
    # (eager), then the K steps of a replayed super-step from the same start
    warm_rows, rows = np.random.default_rng(s_rows).permutation(
        cfg["n_images"])[:2 * K * B].reshape(2, K, B)
    names = [n for n, _ in model.named_parameters()]
    host = lambda ts: {  # noqa: E731  (copies: the window trains on)
        n: t.detach().to("cpu", torch.float32, copy=True)
        for n, t in zip(names, ts)}
    trainer._resident_step(state, wire, torch.from_numpy(rows[:1]).to(dev))
    first_grads = host(torch.zeros_like(p) if p.grad is None else p.grad
                       for p in model.parameters())
    for _ in range(2):
        trainer._resident_step(state, wire, torch.from_numpy(warm_rows)
                               .to(dev))
    _restart(trainer, weights, derive_seeds(s_trainer, 2)[0])
    metrics = trainer._resident_step(state, wire,
                                     torch.from_numpy(rows).to(dev))
    keys = trainer.metric_keys
    checked = {"loss_step1": float(metrics[0, keys.index("loss")]),
               "kl_step1": float(metrics[0, keys.index("kl_loss")]),
               "first_grads": first_grads,
               "change": host(p - weights[n]
                              for n, p in model.named_parameters()),
               "rows": imgs[rows.reshape(-1)].copy(),
               "train_seed": s_trainer, "weights_seed": s_weights}
    del weights, metrics

    # the window's rows, one warm super-step on the first K batches
    supersteps = max(cell.traffic["min_supersteps"],
                     round(cell.seconds / cell.traffic["superstep_s"]))
    order = loader.epoch_order()
    if (supersteps + 1) * K * B > len(order):
        raise ValueError("{} super-steps of {} x {} rows exceed an epoch of "
                         "{}".format(supersteps + 1, K, B, len(order)))
    idx = torch.from_numpy(order[:(supersteps + 1) * K * B].astype(np.int64)
                           .reshape(supersteps + 1, K, B)).to(dev)
    trainer._resident_step(state, wire, idx[0])
    return {"trainer": trainer, "idx": idx, "checked": checked}


def window(cell, state):
    from disvae_tpu_torch.train.trainer import _pack_metrics
    from disvae_tpu_torch.utils.trace import span

    trainer, idx = state["trainer"], state["idx"]
    step, data = trainer._resident_step, trainer.resident_data.wire
    t0 = _now(cell.device)
    rows = []
    for chunk in idx[1:]:
        with span("train.replay"):
            rows.append(step(trainer.state, data, chunk))
    metrics = _pack_metrics(rows)[1]()
    cell.window_s = _now(cell.device) - t0
    loss = metrics[:, trainer.metric_keys.index("loss")]
    K, B = idx.shape[1:]
    steps = (len(idx) - 1) * K
    cell.work.update(attempted=steps, failed=int((~np.isfinite(loss)).sum()),
                     steps=steps, supersteps=len(idx) - 1, images=steps * B,
                     batches={B: steps})


def release(cell, state):
    return state["checked"]


def inputs_of(cell, kept, half=False):
    """The checked steps' seeded weights, batches and noises, on the
    cell's device. `half`: the fault of a step that leaves out half of
    each batch and takes the mean over the rest."""
    cfg, dev = cell.config, cell.device
    img_size = tuple(cfg["img_size"])
    B, D = cfg["batch_size"], cfg["latent_dim"]
    weights = plain.init_params(img_size, kept["weights_seed"], dev,
                                plain.architecture(cfg))
    gen = inputs.generator(dev, derive_seeds(kept["train_seed"], 2)[0])
    # the program's decode of its uint8 wire (train/steps.py)
    x = torch.from_numpy(kept["rows"]).to(dev).float() * (1.0 / 255.0)
    batches = list(x.split(B))
    noises = [torch.randn((B, D), generator=gen, device=dev)
              for _ in batches]
    if half:
        batches = [b[:B // 2] for b in batches]
        noises = [n[:B // 2] for n in noises]
    return weights, batches, noises


def reference(cell, kept, half=False):
    """The reference's K steps from the checked steps' weights, rows and
    noise (plain.train_steps' dict on the host, the parameters' change in
    place of the parameters)."""
    cfg = cell.config
    weights, batches, noises = inputs_of(cell, kept, half)
    ref = plain.train_steps(weights, batches, noises, cfg,
                            cfg["reference_numerics"])
    params = ref.pop("params")
    ref["change"] = {k: params[k] - weights[k] for k in weights}
    return {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
                else v) for k, v in ref.items()}


def leaf_gaps(got, ref):
    """Each moving leaf's first-step gradient gap (the norm of the
    difference over the reference's norm) and its gap of the norms of
    the parameters' change (over the reference's norm)."""
    moving = _moving(ref["first_grads"])
    grads = got["first_grads"], ref["first_grads"]
    change = _norms(got["change"]), _norms(ref["change"])
    return {"grad": {n: float((grads[0][n] - grads[1][n]).norm()
                              / grads[1][n].norm()) for n in moving},
            "change": {n: abs(change[0][n] - change[1][n]) / change[1][n]
                       for n in moving}}


def compare(got, ref):
    """The numbers the check reads (module docstring)."""
    moving = _moving(ref["first_grads"])
    change = [_total(got["change"], moving), _total(ref["change"], moving)]
    return {"loss_gap_step1": abs(got["loss_step1"] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "kl_gap_step1": abs(got["kl_step1"] - ref["kls"][0])
            / abs(ref["kls"][0]),
            "grad_gap": max(leaf_gaps(got, ref)["grad"].values()),
            "grad_bf16_gap": abs(_bf16_share(got["first_grads"], moving)
                                 - _bf16_share(ref["first_grads"], moving)),
            "change_gap": abs(change[0] - change[1]) / change[1]}


def check(cell, kept):
    return compare(kept, reference(cell, kept))


def _norms(tensors):
    return {n: float(t.norm()) for n, t in tensors.items()}


def _total(tensors, names):
    """The norm of `names`' tensors taken together."""
    return float(sum(tensors[n].double().square().sum() for n in names)
                 ** 0.5)


def _moving(ref_grads):
    """Leaves whose reference first gradient's norm is at least a
    thousandth of the median leaf's: the others (the attention's key bias,
    whose gradient is zero in exact arithmetic) hold round-off alone."""
    norms = _norms(ref_grads)
    median = float(np.median(list(norms.values())))
    return [n for n, v in norms.items() if v >= 1e-3 * median]


def _bf16_share(tensors, names):
    """The share of the nonzero float32 elements of `names` that bf16
    holds exactly (the low 16 bits of each are 0)."""
    bits = torch.cat([tensors[n].flatten() for n in names]).view(
        torch.int32)
    nonzero = (bits & 0x7FFFFFFF) != 0
    return float(((bits & 0xFFFF) == 0)[nonzero].double().mean())
