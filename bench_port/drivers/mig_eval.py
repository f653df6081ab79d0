"""MIG/AAM scoring traffic: the eval-only metrics run of a trained model
(`--is-eval-only --is-metrics --no-test`), one model after another.

Traffic parameters: `models` (how many weight sets the evals cycle
through), `min_evals` (the window's least number of evals, and the range
the checked eval is drawn from) and `fast_metrics` (the `--fast-metrics`
entropy estimator).

Set-up renders the full factor lattice, draws `models` weight sets from
the seed and warms the program up with one eval. The window runs whole
evals until `--seconds` have passed: eval i loads weight set i mod
`models` into the model and scores it with a new `Evaluator` on the
streamed eval feed (batch `eval_batchsize`, unshuffled), as the CLI
scores each model, with `metrics_seed` from the seed.

The check: one eval of the window, drawn from the seed, is held to the
reference: the encode of every image (the program's encoder outputs as
that eval made them, relative to their scale) and the marginal and
conditional entropies (nats). MIG and AAM, the eval's answer, follow
from the entropies on the host; they are not compared, since the
control moves them no more than rounding does (PERF.md).
"""

import logging

import numpy as np
import torch

import inputs
from reference import mig as ref_mig
from reference import model as ref_model
from reference.seeds import derive_seeds

QUIET = logging.getLogger("bench_port.program")
QUIET.setLevel(logging.WARNING)


def _dataset(cfg, imgs):
    """The program's dataset class of the configuration over `imgs`, with
    the lattice the configuration states."""
    from disvae_tpu_torch.data.datasets import BaseDataset, get_dataset

    class Lattice(get_dataset(cfg["dataset"])):
        lat_sizes = np.asarray(cfg["lat_sizes"])

        def __init__(self):
            BaseDataset.__init__(self, imgs)
    return Lattice()


def _model_seeds(cell):
    return derive_seeds(cell.seed, cell.traffic["models"] + 1)


def setup(cell):
    from disvae_tpu_torch.data.datasets import DataLoader
    from disvae_tpu_torch.models.vae import VAE
    from disvae_tpu_torch.ops.losses import get_loss_f
    from disvae_tpu_torch.ops.precision import configure

    cfg, dev = cell.config, cell.device
    img_size = tuple(cfg["img_size"])
    configure(cfg["lower_precision"] if cell.control else cfg["precision"])
    *s_models, s_pick = _model_seeds(cell)
    imgs = inputs.sprite_lattice(cfg["lat_sizes"], dev)
    weights = [inputs.vae_weights(img_size, cfg["latent_dim"], s, dev)
               for s in s_models]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = VAE(img_size, cfg["latent_dim"], cfg["model"]).to(dev)
    loader = DataLoader(_dataset(cfg, imgs), batch_size=cfg["eval_batchsize"],
                        shuffle=False)
    loss_f = get_loss_f(cfg["loss"], n_data=len(imgs), **cfg)
    state = {"model": model, "loader": loader, "loss_f": loss_f,
             "weights": weights, "imgs": imgs,
             "pick": int(np.random.default_rng(s_pick).integers(
                 cell.traffic["min_evals"])),
             "metrics_seed": inputs.seed32(cell.seed)}
    _eval(cell, state, 0)  # warm: every shape of the feed, K3's build
    return state


def _eval(cell, state, i, record=None):
    """Score weight set i mod `models` as the eval-only CLI does."""
    from disvae_tpu_torch.train.evaluate import Evaluator
    model = state["model"]
    model.load_state_dict(state["weights"][i % len(state["weights"])])
    evaluator = Evaluator(model, state["loss_f"], logger=QUIET,
                          save_dir=cell.tmp, scramble_quirk=True,
                          metrics_seed=state["metrics_seed"],
                          fast_entropies=cell.traffic["fast_metrics"],
                          resident="auto")
    if record is not None:
        # keep the encode (mu, logvar) of every image as the eval uses it
        encode = evaluator._compute_q_zCx

        def keep(loader):
            samples, params = encode(loader)
            record.append(params)
            return samples, params
        evaluator._compute_q_zCx = keep
    evaluator(state["loader"], is_metrics=True, is_losses=False)
    return evaluator


def window(cell, state):
    import time
    encoded, evals, t0 = [], 0, time.perf_counter()
    while True:
        record = encoded if evals == state["pick"] else None
        evaluator = _eval(cell, state, evals, record)
        cell.timings.append(dict(evaluator.last_metrics_timings))
        if evals == state["pick"]:
            state["answer"] = {"internals": evaluator.last_metrics_internals,
                               "weights": evals % len(state["weights"])}
        evals += 1
        elapsed = time.perf_counter() - t0
        if evals >= cell.traffic["min_evals"] and elapsed >= cell.seconds:
            break
    cell.window_s = elapsed
    cell.work.update(attempted=evals, evals=evals)
    (mu, logvar), = encoded
    state["answer"].update(mu=mu.cpu(), logvar=logvar.cpu())


def release(cell, state):
    return {"answer": state["answer"], "imgs": state["imgs"],
            "metrics_seed": state["metrics_seed"]}


def check(cell, kept):
    cfg, dev = cell.config, cell.device
    img_size = tuple(cfg["img_size"])
    answer = kept["answer"]
    seed = _model_seeds(cell)[answer["weights"]]
    p = inputs.vae_weights(img_size, cfg["latent_dim"], seed, dev)
    imgs = kept["imgs"]
    mus, logvars = [], []
    with torch.no_grad(), ref_model.exact_float32():
        for i in range(0, len(imgs), cfg["eval_batchsize"]):
            x = torch.from_numpy(imgs[i:i + cfg["eval_batchsize"]]).to(dev)
            mu, lv = ref_model.encode(p, x.float(), "float32")
            mus.append(mu)
            logvars.append(lv)
        mu, logvar = torch.cat(mus), torch.cat(logvars)
        h_z, h_zv = ref_mig.entropies(mu, logvar, cfg["lat_sizes"],
                                      kept["metrics_seed"])
    got = answer["internals"]
    return {"encode_gap": max(_rel(answer["mu"], mu.cpu()),
                              _rel(answer["logvar"], logvar.cpu())),
            "entropy_gap": float(max(
                np.abs(got["marginal_entropies"] - h_z).max(),
                np.abs(got["cond_entropies"] - h_zv).max()))}


def _rel(got, ref):
    if got.shape != ref.shape:
        return float("inf")
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))
