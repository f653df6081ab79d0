"""Weights carried across between the JAX package and the port.

Layout logic of disvae_tpu/utils/torch_compat.py:23-57,110-133. The JAX
params pytree holds numpy/JAX arrays as {"encoder": {...}, "decoder": {...}}
with per-layer {"w", "b"}; the port holds a reference-layout state dict.

  * Linear:          JAX (in, out)             <-> torch (out, in)
  * Conv2d:          JAX HWIO                  <-> torch OIHW
  * ConvTranspose2d: JAX HWIO kernel of the equivalent input-dilated forward
    conv <-> torch (in, out, kh, kw): transpose plus a spatial flip.

The FactorVAE discriminator's params ({"lin1": {"w", "b"}, ...}) cross
with `disc_from_jax_params` / `disc_to_jax_params`.
"""

import numpy as np
import torch

_CONV_ENC = ["conv1", "conv2", "conv3", "conv_64"]
_LINEAR_ENC = ["lin1", "lin2", "mu_logvar_gen"]
_LINEAR_DEC = ["lin1", "lin2", "lin3"]
_CONVT_DEC = ["convT_64", "convT1", "convT2", "convT3"]


def _tensor(a):
    # a writable C-contiguous copy: JAX arrays expose read-only buffers
    return torch.from_numpy(np.array(a, order="C"))


def from_jax_params(params):
    """JAX params pytree (arrays) -> reference-layout state dict."""
    sd = {}
    enc, dec = params["encoder"], params["decoder"]
    for k in _CONV_ENC:
        if k in enc:
            w = np.transpose(np.asarray(enc[k]["w"]), (3, 2, 0, 1))
            sd["encoder." + k + ".weight"] = _tensor(w)
            sd["encoder." + k + ".bias"] = _tensor(enc[k]["b"])
    for k in _LINEAR_ENC:
        sd["encoder." + k + ".weight"] = _tensor(np.asarray(enc[k]["w"]).T)
        sd["encoder." + k + ".bias"] = _tensor(enc[k]["b"])
    for k in _LINEAR_DEC:
        sd["decoder." + k + ".weight"] = _tensor(np.asarray(dec[k]["w"]).T)
        sd["decoder." + k + ".bias"] = _tensor(dec[k]["b"])
    for k in _CONVT_DEC:
        if k in dec:
            w = np.transpose(np.asarray(dec[k]["w"]),
                             (2, 3, 0, 1))[:, :, ::-1, ::-1]
            sd["decoder." + k + ".weight"] = _tensor(w)
            sd["decoder." + k + ".bias"] = _tensor(dec[k]["b"])
    return sd


def to_jax_params(state_dict):
    """Reference-layout state dict -> JAX params pytree of numpy arrays."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}

    def lin(prefix):
        return {"w": np.ascontiguousarray(sd[prefix + ".weight"].T),
                "b": np.ascontiguousarray(sd[prefix + ".bias"])}

    enc, dec = {}, {}
    for k in _CONV_ENC:
        prefix = "encoder." + k
        if prefix + ".weight" in sd:
            enc[k] = {"w": np.ascontiguousarray(np.transpose(
                sd[prefix + ".weight"], (2, 3, 1, 0))),
                "b": np.ascontiguousarray(sd[prefix + ".bias"])}
    for k in _LINEAR_ENC:
        enc[k] = lin("encoder." + k)
    for k in _LINEAR_DEC:
        dec[k] = lin("decoder." + k)
    for k in _CONVT_DEC:
        prefix = "decoder." + k
        if prefix + ".weight" in sd:
            w = sd[prefix + ".weight"][:, :, ::-1, ::-1]
            dec[k] = {"w": np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))),
                      "b": np.ascontiguousarray(sd[prefix + ".bias"])}
    return {"encoder": enc, "decoder": dec}


def disc_from_jax_params(params):
    """JAX FactorVAE discriminator params {"lin<i>": {"w", "b"}} -> the
    port's `Discriminator` state dict."""
    sd = {}
    for k, p in params.items():
        sd[k + ".weight"] = _tensor(np.asarray(p["w"]).T)
        sd[k + ".bias"] = _tensor(p["b"])
    return sd


def disc_to_jax_params(state_dict):
    """The port's `Discriminator` state dict -> JAX params of numpy
    arrays."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    return {k[:-len(".weight")]: {
        "w": np.ascontiguousarray(v.T),
        "b": np.ascontiguousarray(sd[k[:-len(".weight")] + ".bias"])}
        for k, v in sd.items() if k.endswith(".weight")}
