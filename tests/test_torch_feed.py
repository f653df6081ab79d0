"""What a whole training run feeds the steps, against the JAX package: the
port Trainer's resident feed walks the JAX loader's epoch order, and the
bitpacked dsprites wire decodes at the evidence run's b64 to the JAX
package's images, bit for bit."""

import torch_threads  # noqa: F401  (first: the thread budget)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from disvae_tpu.data import datasets as JD
from disvae_tpu.train.steps import _decompress_batch as jax_decompress

from disvae_tpu_torch.data import datasets as PD
from disvae_tpu_torch.data.resident import ResidentData
from disvae_tpu_torch.data.synthetic import render_factor_lattice
from disvae_tpu_torch.models.vae import init_specific_model
from disvae_tpu_torch.ops.losses import get_loss_f
from disvae_tpu_torch.train.steps import _decompress_batch
from disvae_tpu_torch.train.trainer import Trainer


def _binary(imgs):
    ds = PD.ArrayDataset(imgs)
    ds.is_binary, ds._scale = True, 1.0
    return ds


@pytest.mark.parametrize("n,batch,k", [(200, 16, 4), (192, 64, 2)])
def test_resident_feed_walks_the_jax_epoch_order(tmp_path, n, batch, k):
    """Three epochs through the Trainer on the resident feed (super-steps
    of k, an epoch's short super-step and its ragged tail): the batches'
    dataset indices, in the order the steps take them, are the JAX
    loader's epoch orders at the same seed."""
    imgs = (np.random.RandomState(0).rand(n, 32, 32, 1) < 0.2).astype(
        np.uint8)
    cfg = get_loss_f("betaH", rec_dist="bernoulli", reg_anneal=0, betaH_B=4)
    model = init_specific_model("Burgess", (1, 32, 32), 4,
                                generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, cfg, lr=1e-3, seed=1, is_progress_bar=False,
                      save_dir=str(tmp_path), steps_per_dispatch=k,
                      resident="always")
    fed = []
    multi, single = trainer._resident_step, trainer._resident_batch

    def record_multi(state, data, idx):
        fed.extend(idx.reshape(-1).tolist())
        return multi(state, data, idx)

    def record_single(wire, idx):
        fed.extend(np.asarray(idx).tolist())
        return single(wire, idx)
    trainer._resident_step = record_multi
    trainer._resident_batch = record_single
    trainer(PD.DataLoader(_binary(imgs), batch_size=batch, shuffle=True,
                          seed=5), epochs=3, checkpoint_every=100)
    assert trainer.resident_data is not None
    ref = JD.DataLoader(JD.ArrayDataset(imgs), batch_size=batch,
                        shuffle=True, seed=5)
    assert fed == np.concatenate([ref.epoch_order()
                                  for _ in range(3)]).tolist()


def test_bitpacked_lattice_decodes_as_jax_at_b64():
    """dsprites-shaped lattice images through the resident upload's wire
    and the step's decode, batches of 64 in a shuffled order: the port's
    decoded batch is the JAX package's, and both are the images."""
    imgs = render_factor_lattice((3, 6, 4, 4, 4))
    wire = ResidentData(_binary(imgs), "cpu").wire
    order = np.random.default_rng(3).permutation(len(imgs))
    for rows in order[:len(order) // 64 * 64].reshape(-1, 64):
        got = _decompress_batch(wire.index_select(0, torch.from_numpy(rows)),
                                (1, 64, 64))
        ref = jax_decompress(jnp.asarray(wire.numpy()[rows]), (1, 64, 64))
        assert got.shape == (64, 64, 64, 1) and got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(ref))
        assert np.array_equal(got.numpy(), imgs[rows].astype(np.float32))
