"""The JAX CLI's btcvae_dsprites init at -s 1234, committed for the port's
evidence run (tests/data/jax_init_btcvae_dsprites_s1234/, written by
`python tests/evidence_witness.py init DIR`), held to the JAX package.

np.savez stamps each array's zip entry with the time it was written, so
the file's bytes differ between two writes of the same arrays: the
committed file is compared array by array, each bit for bit.
"""

import json
import os
import sys

import jax
import numpy as np

from disvae_tpu.utils.modelIO import _flatten

from disvae_tpu_torch.utils.modelIO import load_model
from disvae_tpu_torch.utils.torch_compat import to_jax_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import evidence_witness  # noqa: E402

INIT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jax_init_btcvae_dsprites_s1234")


def _committed():
    with np.load(os.path.join(INIT_DIR, "model.npz")) as data:
        return {k: data[k] for k in data.files}


def test_committed_init_is_the_jax_clis():
    """The JAX package rebuilds the committed arrays bit for bit, under
    the key and the threefry mode the specs name."""
    _, params, metadata = evidence_witness.init_weights()
    want = {k: np.asarray(v) for k, v in _flatten(params).items()}
    have = _committed()
    assert sorted(have) == sorted(want)
    for k, v in want.items():
        assert have[k].dtype == v.dtype and have[k].shape == v.shape, k
        assert have[k].tobytes() == v.tobytes(), k
    with open(os.path.join(INIT_DIR, "specs.json")) as f:
        specs = json.load(f)
    assert specs == metadata
    assert specs["jax_threefry_partitionable"] \
        == jax.config.jax_threefry_partitionable
    assert sum(v.size for v in have.values()) == 502005


def test_port_loads_the_committed_init():
    """The port's load_model reads the committed model.npz; converted back
    with torch_compat it gives the same arrays bit for bit."""
    model = load_model(INIT_DIR)
    assert (model.model_type, tuple(model.img_size), model.latent_dim) \
        == ("Burgess", (1, 64, 64), 10)
    back = _flatten(to_jax_params({k: v.detach() for k, v in
                                   model.state_dict().items()}))
    have = _committed()
    assert sorted(back) == sorted(have)
    for k, v in have.items():
        got = np.asarray(back[k])
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k
