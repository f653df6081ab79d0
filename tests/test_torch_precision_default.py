"""The port's ``--precision default`` against what the JAX CLI's
``default`` computes on a TPU, and its bf16 compute dtype against JAX's.

On a TPU a float32 conv or dot under JAX's ``default`` precision is one
bf16 MXU pass: bf16-rounded operands, float32 sums, float32 outputs; the
bias is added in float32; a backward conv or dot rounds the cotangent it
takes as an operand, and the bias gradient sums the float32 cotangent.
XLA on the CPU ignores the matmul precision, so the JAX side here is the
JAX package's own `conv2d`, `conv2d_transpose` and `linear`
(disvae_tpu/ops/convs.py) under ``highest`` (tests/conftest.py), wrapped
in `jax.custom_vjp`s that round the operands (the gradient passing
straight through) and the cotangent: the TPU-DEFAULT reference.

Bounds, max |d| / max |ref| unless said otherwise:
* (a) one layer, forward and backward, port against the reference on the
  same inputs: 1e-5 (exact products, float32 sums in another order).
* (b) one train step per loss from the same weights (utils/torch_compat)
  and the same pinned noise: metrics rtol 1e-4 (atol 1e-6), mu/logvar
  1e-4, each gradient 7e-3, parameters after Adam atol lr / 10 where the
  gradient is at least 1% of its tensor's largest (elsewhere Adam's first
  step, lr * g / (|g| + eps), can move by any fraction of lr). The two
  sides sum in another order, so a value one float32 rounding apart can
  round to the neighbouring bf16 value (a step of 2^-8 of it), and such a
  difference grows: the next layer's values then differ by a share of a
  bf16 step, more of them round apart, and within about five layers the
  two sides differ by bf16 steps. The steps run at b8 32x32 and b4
  64x64x3, where the forward rounds every value alike on both sides
  (mu/logvar within 1.3e-7); the gradient bound leaves room for the few
  cotangents and 1000-unit discriminator values that round apart (up to
  4.4e-3). At b8 64x64x1 the forward already rounds apart (mu/logvar
  3.4e-3 off): no step comparison is finer than bf16 there, and (a)
  holds each layer at any size.
* (c) the bf16 autocast mode (``compute_dtype="bfloat16"``, the port's
  ``default`` before) misses the (b) reference by more than 10x (b)'s
  bounds on mu/logvar and on the gradients.
* (d) ``compute_dtype="bfloat16"`` against JAX's ``VAE(compute_dtype=
  "bfloat16")``: 2e-2 on the outputs (bf16 outputs rounded in another
  order).
* (e) ``highest`` and ``high``: outputs and gradients bitwise those of
  the plain F.conv2d / F.conv_transpose2d / F.linear calls.
"""

import torch_threads  # noqa: F401  (first: the thread budget)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from disvae_tpu.models import burgess as jax_burgess
from disvae_tpu.models import discriminator as jax_disc_mod
from disvae_tpu.models.discriminator import Discriminator as JaxDisc
from disvae_tpu.models.vae import init_specific_model as jax_init
from disvae_tpu.ops import convs as JC
from disvae_tpu.ops import losses as JL
from disvae_tpu.ops.pallas_convt_bwd import convt3_bwd_pl
from disvae_tpu.train.state import create_train_state as jax_state
from disvae_tpu.train.steps import make_disc_optimizer as jax_disc_opt
from disvae_tpu.train.steps import make_optimizer as jax_opt
from disvae_tpu.train.steps import make_train_step as jax_step

from disvae_tpu_torch.models import burgess
from disvae_tpu_torch.models.discriminator import Discriminator
from disvae_tpu_torch.models.vae import VAE
from disvae_tpu_torch.ops import losses as PL
from disvae_tpu_torch.ops import precision
from disvae_tpu_torch.ops.convt_bwd import conv_transpose2d_pl
from disvae_tpu_torch.train.state import create_train_state
from disvae_tpu_torch.train.steps import (make_disc_optimizer,
                                          make_optimizer, make_train_step)
from disvae_tpu_torch.utils.torch_compat import (disc_from_jax_params,
                                                 disc_to_jax_params,
                                                 from_jax_params,
                                                 to_jax_params)
# the JAX step's noise and gradients, and the losses' settings, as the
# port's float32 one-step test has them
from test_torch_train import KWARGS, LR, _jax_grads, _jax_noise, _leaves

LAYER_TOL = 1e-5
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-6
LATENT_TOL, GRAD_TOL = 1e-4, 7e-3
BF16_OUT_TOL = 2e-2
LOSSES = ["VAE", "betaH", "betaB", "btcvae", "factor"]


# ----------------------------------------------------------------------
# the TPU-DEFAULT reference: the JAX package's layers on rounded operands
# ----------------------------------------------------------------------

def _round(t):
    return t.astype(jnp.bfloat16).astype(t.dtype)


@jax.custom_vjp
def _operand(t):
    return _round(t)


_operand.defvjp(lambda t: (_round(t), None), lambda _, g: (g,))


@jax.custom_vjp
def _cotangent(t):
    return t


_cotangent.defvjp(lambda t: (t, None), lambda _, g: (_round(g),))


def tpu_conv2d(x, w, b, stride=2, padding=1):
    return _cotangent(JC.conv2d(_operand(x), _operand(w), 0.0, stride,
                                padding)) + b


def tpu_conv2d_transpose(x, w, b, stride=2, padding=1, ksize=4):
    return _cotangent(JC.conv2d_transpose(_operand(x), _operand(w), 0.0,
                                          stride, padding, ksize)) + b


def tpu_linear(x, p):
    return _cotangent(JC.linear(_operand(x), {"w": _operand(p["w"]),
                                              "b": 0.0})) + p["b"]


@pytest.fixture
def tpu_default(monkeypatch):
    """The JAX model's and discriminator's layers as the TPU computes them
    under ``default``."""
    monkeypatch.setattr(jax_burgess, "conv2d", tpu_conv2d)
    monkeypatch.setattr(jax_burgess, "conv2d_transpose", tpu_conv2d_transpose)
    monkeypatch.setattr(jax_burgess, "_convT_final", tpu_conv2d_transpose)
    monkeypatch.setattr(jax_burgess, "linear", tpu_linear)
    monkeypatch.setattr(jax_disc_mod, "linear", tpu_linear)


@pytest.fixture
def policy():
    saved = precision.current()
    yield precision.configure
    precision.configure(saved)
    burgess.set_final_convt_impl(burgess.conv_transpose2d)


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    return np.abs(ref - np.asarray(got, np.float64)).max() / (
        np.abs(ref).max() + 1e-30)


# ----------------------------------------------------------------------
# (a) one layer
# ----------------------------------------------------------------------

# (kind, x shape NCHW or (B, in), torch weight shape)
LAYERS = {
    "conv first 32": ("conv", (8, 1, 32, 32), (32, 1, 4, 4)),
    "conv 32ch": ("conv", (8, 32, 16, 16), (32, 32, 4, 4)),
    "convT 32ch": ("convT", (8, 32, 8, 8), (32, 32, 4, 4)),
    "convT final Cout 1": ("convT", (8, 32, 16, 16), (32, 1, 4, 4)),
    "convT final Cout 3, 64": ("convT", (8, 32, 32, 32), (32, 3, 4, 4)),
    "convT final hook": ("hook", (8, 32, 16, 16), (32, 3, 4, 4)),
    "linear": ("linear", (8, 512), (256, 512)),
    "discriminator linear": ("linear", (8, 1000), (1000, 1000)),
}


def _layer_inputs(kind, xs, ws, seed=0):
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(*xs), 0).astype(np.float32)
    w = (0.1 * rng.randn(*ws)).astype(np.float32)
    b = rng.randn(ws[0] if kind in ("conv", "linear") else ws[1]).astype(
        np.float32)
    return x, w, b


def _port_layer(kind, x, w, b, g):
    fn = {"conv": precision.conv2d, "convT": precision.conv_transpose2d,
          "hook": conv_transpose2d_pl, "linear": precision.linear}[kind]
    t = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y = fn(*t)
    y.backward(torch.from_numpy(g))
    return [y.detach().numpy()] + [a.grad.numpy() for a in t]


def _jax_layer(kind, x, w, b, g):
    """The TPU-DEFAULT reference in the port's layouts."""
    if kind == "linear":
        y, vjp = jax.vjp(lambda x, w, b: tpu_linear(x, {"w": w, "b": b}),
                         x, w.T, b)
        dx, dw, db = vjp(g)
        return [np.asarray(y), np.asarray(dx), np.asarray(dw).T,
                np.asarray(db)]
    nhwc = (0, 2, 3, 1)
    if kind == "conv":
        wj = w.transpose(2, 3, 1, 0)        # OIHW -> HWIO
        fn = tpu_conv2d
    else:                                   # (in, out, kh, kw) -> HWIO
        wj = w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        fn = tpu_conv2d_transpose
    y, vjp = jax.vjp(fn, x.transpose(nhwc), np.ascontiguousarray(wj), b)
    dx, dw, db = vjp(g.transpose(nhwc))
    dw = np.asarray(dw)
    dw = (dw.transpose(3, 2, 0, 1) if kind == "conv"
          else dw.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    return [np.asarray(y).transpose(0, 3, 1, 2),
            np.asarray(dx).transpose(0, 3, 1, 2), dw, np.asarray(db)]


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_matches_the_tpu_default_reference(layer, policy):
    """Forward, dx, dw and db of one layer under ``default`` against the
    JAX package's layer on bf16-rounded operands with a rounded
    cotangent, within 1e-5; every output float32."""
    policy("default")
    kind, xs, ws = LAYERS[layer]
    x, w, b = _layer_inputs(kind, xs, ws)
    g = np.random.RandomState(1).randn(*_out_shape(kind, xs, ws)).astype(
        np.float32)
    got = _port_layer(kind, x, w, b, g)
    want = _jax_layer(kind, x, w, b, g)
    for name, r, p in zip(("y", "dx", "dw", "db"), want, got):
        assert p.dtype == np.float32, name
        assert p.shape == r.shape, name
        assert _rel(r, p) <= LAYER_TOL, (name, _rel(r, p))


def _out_shape(kind, xs, ws):
    if kind == "linear":
        return (xs[0], ws[0])
    if kind == "conv":
        return (xs[0], ws[0], xs[2] // 2, xs[3] // 2)
    return (xs[0], ws[1], 2 * xs[2], 2 * xs[3])


def test_hook_backward_is_convt3_bwd_pl_on_bf16_operands(policy):
    """The K1/K2 hook's backward under ``default`` (on the CPU the plain
    K1/K2) against JAX's `convt3_bwd_pl` (its Pallas kernels in interpret
    mode, bf16 contraction operands) on the same bf16-rounded x, the
    float32 w and the float32 dy: dx, dw and db within 1e-5."""
    policy("default")
    x, w, b = _layer_inputs("convT", (4, 32, 16, 16), (32, 3, 4, 4), seed=3)
    g = np.random.RandomState(4).randn(4, 3, 32, 32).astype(np.float32)
    _, dx, dw, db = _port_layer("hook", x, w, b, g)
    xr = precision.round_bf16(torch.from_numpy(x)).numpy()
    jdx, jdw, jdb = convt3_bwd_pl(
        xr.transpose(0, 2, 3, 1),
        np.ascontiguousarray(w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)),
        g.transpose(0, 2, 3, 1), interpret=True, cdt=jnp.bfloat16)
    assert _rel(np.asarray(jdx).transpose(0, 3, 1, 2), dx) <= LAYER_TOL
    assert _rel(np.asarray(jdw).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1],
                dw) <= LAYER_TOL
    assert _rel(jdb, db) <= LAYER_TOL


def test_default_policy_flags_and_marker(policy):
    """``default`` allows TF32 (exact on bf16 values) and keeps float32
    matmuls at "high", never "medium" (bf16 internal GEMMs); the policy
    is a module variable. Inside autocast the layers are the plain calls
    (bf16 out)."""
    policy("default")
    assert precision.current() == "default"
    assert torch.get_float32_matmul_precision() == "high"
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    x, w, b = (torch.from_numpy(a) for a in _layer_inputs(
        "linear", (4, 16), (8, 16)))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = precision.linear(x, w, b)
        ref = F.linear(x, w, b)
    assert y.dtype == torch.bfloat16 and torch.equal(y, ref)
    y = precision.linear(x, w, b)
    assert y.dtype == torch.float32 and not torch.equal(y, F.linear(x, w, b))
    policy("high")
    assert torch.equal(precision.linear(x, w, b), F.linear(x, w, b))


# ----------------------------------------------------------------------
# (b), (c) one train step per loss
# ----------------------------------------------------------------------

def _one_step(loss, img_size, compute_dtype="float32", hook=False, b=8,
              d=10):
    """One train step of the JAX package (as the caller's fixtures set its
    layers) and of the port under the current policy, from the same
    weights, batch and noise. Returns the metrics, the (mu, logvar) of
    the batch at the initial weights, and per tensor (name, JAX grad,
    port grad, JAX param after the step, port param after the step)."""
    c, h, _ = img_size
    batch = (np.random.RandomState(0).rand(b, h, h, c) * 255).astype(
        np.uint8)
    j_cfg = JL.get_loss_f(loss, **KWARGS)
    p_cfg = PL.get_loss_f(loss, **KWARGS)
    model, params = jax_init("Burgess", img_size, d,
                             key=jax.random.PRNGKey(0))
    disc = d_opt = None
    if j_cfg.needs_discriminator:
        disc, d_opt = JaxDisc(latent_dim=d), jax_disc_opt(j_cfg)
    state = jax_state(model, params, jax_opt(LR), jax.random.PRNGKey(1),
                      disc=disc, disc_optimizer=d_opt,
                      disc_rng=jax.random.PRNGKey(2), loss_cfg=j_cfg)
    noise = _jax_noise(j_cfg, state.rng, b, d)
    x = jnp.asarray(batch) / 255.0
    j_lat = model.encode(params, x)
    j_grads, j_dgrads = _jax_grads(j_cfg, model, disc, state, x, state.rng)
    j_new, j_metrics = jax_step(model, j_cfg, jax_opt(LR), disc=disc,
                                disc_optimizer=d_opt, donate=False)(
        state, jnp.asarray(batch))

    port = VAE(img_size, d, compute_dtype=compute_dtype)
    port.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.array, params)))
    with torch.no_grad():
        p_lat = port.encode(torch.from_numpy(np.asarray(x)))
    p_disc = p_dopt = None
    if p_cfg.needs_discriminator:
        p_disc = Discriminator(latent_dim=d)
        p_disc.load_state_dict(disc_from_jax_params(
            jax.tree_util.tree_map(np.array, state.disc_params)))
        p_dopt = make_disc_optimizer(p_disc.parameters(), p_cfg)
    p_state = create_train_state(port, make_optimizer(port.parameters(), LR),
                                 torch.Generator(), disc=p_disc,
                                 disc_optimizer=p_dopt, loss_cfg=p_cfg)
    p_noise = {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}
    if "perm" in p_noise:
        p_noise["perm"] = p_noise["perm"].long()
    if hook:
        burgess.set_final_convt_impl(conv_transpose2d_pl)
    try:
        p_metrics = make_train_step(p_cfg)(p_state, torch.from_numpy(batch),
                                           p_noise)
    finally:
        burgess.set_final_convt_impl(burgess.conv_transpose2d)
    metrics = {k: (float(j_metrics[k]), float(p_metrics[k]))
               for k in j_metrics}
    assert set(p_metrics) == set(j_metrics)
    latents = [(np.asarray(j), p.numpy()) for j, p in zip(j_lat, p_lat)]
    pairs = [(to_jax_params({k: p.grad for k, p in port.named_parameters()}),
              j_grads, to_jax_params(port.state_dict()), j_new.params)]
    if p_disc is not None:
        pairs.append((disc_to_jax_params(
            {k: p.grad for k, p in p_disc.named_parameters()}), j_dgrads,
            disc_to_jax_params(p_disc.state_dict()), j_new.disc_params))
    tensors = []
    for p_g, j_g, p_p, j_p in pairs:
        p_g, j_g, p_p, j_p = map(_leaves, (p_g, j_g, p_p, j_p))
        assert set(p_g) == set(j_g)
        tensors += [(str(k), np.asarray(j_g[k]), np.asarray(p_g[k]),
                     np.asarray(j_p[k]), np.asarray(p_p[k])) for k in j_g]
    return metrics, latents, tensors


# (loss, img_size, batch, K1/K2 hook)
STEP_CASES = [(loss, (1, 32, 32), 8, False) for loss in LOSSES] + [
    ("betaB", (1, 32, 32), 8, True), ("btcvae", (3, 64, 64), 4, True),
    ("factor", (3, 64, 64), 4, False)]


@pytest.fixture
def one_thread():
    """The port's CPU sums in one order whatever the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize(
    "loss,img_size,b,hook", STEP_CASES,
    ids=["{}-{}-b{}{}".format(l, s[1], b, "-hook" if k else "")
         for l, s, b, k in STEP_CASES])
def test_one_step_matches_the_tpu_default_reference(
        loss, img_size, b, hook, policy, tpu_default, one_thread):
    """One train step under ``default`` (with the K1/K2 hook: its plain
    versions) against JAX's step with TPU-DEFAULT layers: the metrics,
    mu/logvar, every gradient and every parameter after Adam (module
    docstring (b))."""
    policy("default")
    metrics, latents, tensors = _one_step(loss, img_size, hook=hook, b=b)
    for k, (j, p) in metrics.items():
        assert abs(p - j) <= METRIC_ATOL + METRIC_RTOL * abs(j), (k, j, p)
    for j, p in latents:
        assert p.dtype == np.float32 and _rel(j, p) <= LATENT_TOL, _rel(j, p)
    for name, j_g, p_g, j_p, p_p in tensors:
        assert _rel(j_g, p_g) <= GRAD_TOL, (name, _rel(j_g, p_g))
        big = np.abs(j_g) >= 0.01 * np.abs(j_g).max()
        np.testing.assert_allclose(p_p[big], j_p[big], atol=LR / 10, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("loss", LOSSES)
def test_bf16_autocast_misses_the_tpu_default_reference(loss, policy,
                                                        tpu_default,
                                                        one_thread):
    """The fault this policy repairs, on (b)'s inputs: bf16 autocast (the
    bf16 compute dtype, the port's ``default`` before) misses the
    TPU-DEFAULT reference by more than 10x (b)'s bounds on mu/logvar and
    on the gradients."""
    policy("default")
    _, latents, tensors = _one_step(loss, (1, 32, 32),
                                    compute_dtype="bfloat16")
    assert max(_rel(j, p) for j, p in latents) > 10 * LATENT_TOL
    assert max(_rel(j_g, p_g) for _, j_g, p_g, _, _ in tensors) \
        > 10 * GRAD_TOL


# ----------------------------------------------------------------------
# (d) the bf16 compute dtype against JAX's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("img_size", [(1, 32, 32), (3, 64, 64)])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_compute_dtype_matches_jax(img_size, train, policy):
    """`VAE(compute_dtype="bfloat16")` (autocast) against JAX's
    `VAE(compute_dtype="bfloat16")` on the same weights and noise: the
    reconstruction and (mu, logvar) float32, within 2e-2 (module docstring
    (d)). Gradients are not compared: XLA on the CPU sums the bf16
    cotangents of the bias gradients in bf16 (JAX's were up to 78%
    smaller in magnitude than the port's float32-accumulated ones)."""
    policy("default")
    c, h, _ = img_size
    rng = np.random.RandomState(3)
    x = rng.rand(8, h, h, c).astype(np.float32)
    eps = rng.randn(8, 10).astype(np.float32)
    model, params = jax_init("Burgess", img_size, 10,
                             key=jax.random.PRNGKey(4),
                             compute_dtype="bfloat16")
    port = VAE(img_size, 10, compute_dtype="bfloat16")
    port.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.array, params)))
    port.train(train)
    j_mu, j_lv = model.encode(params, jnp.asarray(x))
    j_z = j_mu + jnp.exp(0.5 * j_lv) * eps if train else j_mu
    j_rec = model.decode(params, j_z)
    with torch.no_grad():
        p_rec, (p_mu, p_lv), _ = port(torch.from_numpy(x),
                                      eps=torch.from_numpy(eps))
    for j, p in ((j_rec, p_rec), (j_mu, p_mu), (j_lv, p_lv)):
        assert p.dtype == torch.float32
        assert _rel(j, p.numpy()) <= BF16_OUT_TOL, _rel(j, p.numpy())


# ----------------------------------------------------------------------
# (e) highest and high: the plain calls, bit for bit
# ----------------------------------------------------------------------

def _plain_forward(model, x, eps):
    """The Burgess VAE's forward as plain F calls on the model's weights
    (the port's model code before the policy's layers)."""
    enc, dec = model.encoder, model.decoder

    def conv(m, h):
        return F.conv2d(h, m.weight, m.bias, stride=2, padding=1)

    def convt(m, h):
        return F.conv_transpose2d(h, m.weight, m.bias, stride=2, padding=1)

    def lin(m, h):
        return F.linear(h, m.weight, m.bias)
    h = x.permute(0, 3, 1, 2)
    for name in ("conv1", "conv2", "conv3", "conv_64"):
        if getattr(enc, name) is not None:
            h = F.relu(conv(getattr(enc, name), h))
    h = h.reshape(h.shape[0], -1)
    h = F.relu(lin(enc.lin2, F.relu(lin(enc.lin1, h))))
    mu, logvar = lin(enc.mu_logvar_gen, h).view(
        -1, model.latent_dim, 2).unbind(-1)
    z = mu + torch.exp(0.5 * logvar) * eps
    h = F.relu(lin(dec.lin1, z))
    h = F.relu(lin(dec.lin3, F.relu(lin(dec.lin2, h))))
    h = h.view(-1, 32, 4, 4)
    for name in ("convT_64", "convT1", "convT2"):
        if getattr(dec, name) is not None:
            h = F.relu(convt(getattr(dec, name), h))
    rec = torch.sigmoid(convt(dec.convT3, h)).permute(0, 2, 3, 1)
    return rec, mu, logvar


@pytest.mark.parametrize("img_size", [(1, 32, 32), (3, 64, 64)])
@pytest.mark.parametrize("name", ["highest", "high"])
def test_parity_policies_are_the_plain_calls(name, img_size, policy):
    """Under ``highest`` and ``high`` the model's outputs and gradients,
    and the discriminator's, are bitwise those of the plain F calls."""
    policy(name)
    c, h, _ = img_size
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.rand(4, h, h, c).astype(np.float32))
    eps = torch.from_numpy(rng.randn(4, 10).astype(np.float32))
    model = VAE(img_size, 10)
    outs, grads = [], []
    for port in (True, False):
        model.zero_grad()
        if port:
            rec, (mu, logvar), _ = model(x, eps=eps)
        else:
            rec, mu, logvar = _plain_forward(model, x, eps)
        (rec.square().sum() + mu.sum() + logvar.exp().sum()).backward()
        outs.append((rec, mu, logvar))
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    disc = Discriminator(latent_dim=10)
    z = torch.from_numpy(rng.randn(8, 10).astype(np.float32))
    h = z
    for i in range(1, 7):
        lin = getattr(disc, "lin{}".format(i))
        h = F.linear(h, lin.weight, lin.bias)
        h = F.leaky_relu(h, 0.2) if i < 6 else h
    assert torch.equal(disc(z), h)
