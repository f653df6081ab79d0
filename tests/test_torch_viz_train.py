"""The per-epoch training gif through the port's CLI and Trainer.

A training run with the gif leaves the same parameters, bit for bit, as
the same run without it: a frame decodes in eval mode under no_grad, puts
the model back in train mode, and draws from no generator of the run.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from disvae_tpu_torch import cli
from disvae_tpu_torch.data import datasets as PD
from disvae_tpu_torch.models.vae import init_specific_model
from disvae_tpu_torch.ops import losses as PL
from disvae_tpu_torch.train.trainer import Trainer
from disvae_tpu_torch.utils.visualize import GifTraversalsTraining


def _n_frames(path):
    with Image.open(path) as im:
        return im.n_frames, im.size


@pytest.mark.parametrize("loss, resident", [("btcvae", "always"),
                                            ("factor", "never")])
def test_cli_gif_run_writes_frames_and_matches_no_gif_run(tmp_path,
                                                          monkeypatch, loss,
                                                          resident):
    root = tmp_path / "data" / "mnist"
    root.mkdir(parents=True)
    rng = np.random.RandomState(0)
    np.savez_compressed(root / "train32.npz",
                        imgs=(rng.rand(40, 32, 32, 1) * 255).astype(np.uint8),
                        labels=np.zeros(40, np.int32))
    monkeypatch.setattr(PD, "DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.chdir(tmp_path)
    # FactorVAE doubles the epochs (and the batch): 2 epochs either way
    flags = ["--no-cuda", "-d", "mnist", "-l", loss, "-b", "8", "-e",
             "1" if loss == "factor" else "2", "--checkpoint-every", "1",
             "--no-progress-bar", "-s", "3", "--no-test", "--resident-data",
             resident]
    gif_trainer, _ = cli.main(cli.parse_arguments(["gif"] + flags))
    plain_trainer, _ = cli.main(cli.parse_arguments(["plain", "--no-viz-gif"]
                                                    + flags))
    epochs = 2
    n, size = _n_frames(tmp_path / "results" / "gif" / "training.gif")
    # z = 10 rows of 10 traversal steps, 32 px cells
    assert n == epochs and size == (10 * 34 + 2, 10 * 34 + 2)
    assert not (tmp_path / "results" / "plain" / "training.gif").exists()
    assert gif_trainer.state.step == plain_trainer.state.step
    for (k, a), b in zip(gif_trainer.model.state_dict().items(),
                         plain_trainer.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert gif_trainer.model.training == plain_trainer.model.training


def test_trainer_gif_hook_changes_nothing_it_does_not_own(tmp_path):
    """A frame between epochs leaves the parameters, the train mode and the
    training generator's state as the same epochs leave them without it."""
    cfg = PL.get_loss_f("btcvae", rec_dist="bernoulli", reg_anneal=0,
                        btcvae_A=1, btcvae_B=6, btcvae_G=1, n_data=48)
    imgs = (np.random.RandomState(1).rand(48, 32, 32, 1) * 255).astype(
        np.uint8)
    runs = {}
    for name in ("gif", "plain"):
        model = init_specific_model("Burgess", (1, 32, 32), 10,
                                    generator=torch.Generator().manual_seed(0))
        gif = (GifTraversalsTraining(model, "mnist", str(tmp_path / name),
                                     n_per_latent=3)
               if name == "gif" else None)
        (tmp_path / name).mkdir()
        trainer = Trainer(model, cfg, lr=5e-4, seed=1,
                          save_dir=str(tmp_path / name), gif_visualizer=gif,
                          is_progress_bar=False, resident="never")
        trainer(PD.DataLoader(PD.ArrayDataset(imgs), batch_size=16,
                              shuffle=True, seed=0),
                epochs=3, checkpoint_every=10)
        runs[name] = trainer
    assert _n_frames(tmp_path / "gif" / "training.gif")[0] == 3
    a, b = runs["gif"], runs["plain"]
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    assert torch.equal(a.state.generator.get_state(),
                       b.state.generator.get_state())
    assert a.model.training == b.model.training
