"""The resident super-step replayed as a CUDA graph against the eager one:
cases shared by the card tests (tests/test_torch_gpu.py) and chip_smoke.py.
torch and numpy only, no jax.

Each loss trains with its `<loss>_dsprites` experiment's settings from
hyperparam.ini, at dsprites shapes: Burgess 64 x 64 x 1, latent 10, the
bitpacked wire format, N = 737,280 in the MSS weights.
"""

import numpy as np
import torch

LOSSES = ["VAE", "betaH", "betaB", "factor", "btcvae"]
N_DSPRITES = 737280
# hyperparam.ini's [Custom] defaults, then each <loss>_dsprites experiment's
# own lr and coefficients
BASE = dict(rec_dist="bernoulli", reg_anneal=10000, betaH_B=4,
            betaB_initC=0, betaB_finC=25, betaB_G=100, factor_G=6,
            lr_disc=5e-5, btcvae_A=1, btcvae_B=6, btcvae_G=1, latent_dim=10)
CASES = {
    "VAE": (5e-4, {}),
    "betaH": (5e-4, dict(betaH_B=4)),
    "betaB": (1e-3, dict(betaB_finC=25, reg_anneal=100000)),
    "factor": (1e-4, dict(factor_G=6.4, lr_disc=1e-4)),
    "btcvae": (5e-4, dict(btcvae_B=6.4)),
}


def binary_wire(n, device, seed=0):
    """(n, 512) uint8 on `device`: n bitpacked 64 x 64 binary images, a
    tenth of the pixels set (dsprites' wire format)."""
    bits = np.random.RandomState(seed).rand(n, 64 * 64) < 0.1
    return torch.from_numpy(np.packbits(bits, axis=1)).to(device)


def loss_config(loss, n_data=N_DSPRITES):
    from disvae_tpu_torch.ops.losses import get_loss_f
    lr, kwargs = CASES[loss]
    return lr, get_loss_f(loss, n_data=n_data, **dict(BASE, **kwargs))


def train_state(loss, device, img_size=(1, 64, 64), seed=0,
                compute_dtype="float32"):
    """(loss config, TrainState) seeded from `seed`: the model (of
    `compute_dtype`, models/vae.py), its Adam, FactorVAE's discriminator
    and its Adam, the noise generator."""
    from disvae_tpu_torch.models.discriminator import Discriminator
    from disvae_tpu_torch.models.vae import init_specific_model
    from disvae_tpu_torch.train.state import create_train_state
    from disvae_tpu_torch.train.steps import (make_disc_optimizer,
                                              make_optimizer)
    lr, cfg = loss_config(loss)
    model = init_specific_model(
        "Burgess", img_size, 10,
        generator=torch.Generator().manual_seed(seed), device=device,
        compute_dtype=compute_dtype)
    disc = disc_optimizer = None
    if cfg.needs_discriminator:
        disc = Discriminator(latent_dim=10, generator=torch.Generator()
                             .manual_seed(seed + 1)).to(device)
        disc_optimizer = make_disc_optimizer(disc.parameters(), cfg)
    state = create_train_state(
        model, make_optimizer(model.parameters(), lr),
        torch.Generator(device=device).manual_seed(seed + 2), disc=disc,
        disc_optimizer=disc_optimizer, loss_cfg=cfg)
    return cfg, state


def super_step(cfg, state, k, graph):
    """The resident super-step of `cfg` on `state`; with `graph`, replayed
    as a CUDA graph of `k` steps."""
    from disvae_tpu_torch.ops.losses import metric_key_order
    from disvae_tpu_torch.train.steps import make_resident_multi_train_step
    return make_resident_multi_train_step(
        cfg, metric_key_order(cfg.name, 10), state=state,
        graph_steps=k if graph else None)


def run(step, state, wire, idx, k):
    """Super-steps over the rows of `idx` (n, B), k at a time; their
    metrics rows, (n, n_keys)."""
    return torch.cat([step(state, wire, idx[i:i + k])
                      for i in range(0, len(idx), k)])


def graph_against_eager(loss, wire, idx, k, img_size=(1, 64, 64),
                        compute_dtype="float32"):
    """Super-steps of `k` steps over the rows of `idx`, eagerly and
    graphed, each from the same seed: (eager metrics, graphed metrics,
    eager state, graphed state, the graphed super-step)."""
    out = []
    for graph in (False, True):
        cfg, state = train_state(loss, wire.device, img_size,
                                 compute_dtype=compute_dtype)
        step = super_step(cfg, state, k, graph)
        out.append((run(step, state, wire, idx, k), state, step))
    torch.cuda.synchronize()
    (m_eager, s_eager, _), (m_graph, s_graph, step) = out
    return m_eager, m_graph, s_eager, s_graph, step


def differences(a, b):
    """What differs, bit for bit, between two train states: the names of
    parameters, gradients, Adam's state tensors, the generator's state and
    the two step counters that are not equal. [] when none is."""
    out = []
    if a.step != b.step:
        out.append("step")
    if not torch.equal(a.device_step, b.device_step):
        out.append("device_step")
    if not torch.equal(a.generator.get_state(), b.generator.get_state()):
        out.append("generator")
    for tag, ma, mb in (("model", a.model, b.model),
                        ("disc", a.disc, b.disc)):
        if ma is None:
            continue
        for (name, p), q in zip(ma.named_parameters(), mb.parameters()):
            if not torch.equal(p, q):
                out.append("{}.{}".format(tag, name))
            if (p.grad is None) != (q.grad is None) or (
                    p.grad is not None and not torch.equal(p.grad, q.grad)):
                out.append("{}.{}.grad".format(tag, name))
    for tag, oa, ob in (("optimizer", a.optimizer, b.optimizer),
                        ("disc_optimizer", a.disc_optimizer,
                         b.disc_optimizer)):
        if oa is None:
            continue
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        for i in sa:
            for key, v in sa[i].items():
                if not torch.equal(v, sb[i][key]):
                    out.append("{}.{}.{}".format(tag, i, key))
    return out
