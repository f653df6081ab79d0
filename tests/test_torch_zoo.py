"""chip_smoke.py phase 17's runs, held on the CPU to the JAX runs they are
compared with: the flags the phase builds for each run, parsed by the
port's CLI, give that run's specs.json in every field that defines it."""

import json
import os
import sys

import pytest

from disvae_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (imports only torch and numpy at the top)

FIELDS = ("dataset", "loss", "lr", "batch_size", "latent_dim", "model_type",
          "rec_dist", "reg_anneal", "precision", "seed", "betaH_B", "betaB_G",
          "betaB_initC", "betaB_finC")


@pytest.mark.parametrize("name, jax_run, gif", chip_smoke.ZOO_RUNS)
def test_zoo_flags_reproduce_the_jax_run(name, jax_run, gif):
    with open(os.path.join(REPO, "artifacts", jax_run, "specs.json")) as f:
        specs = json.load(f)
    args = cli.parse_arguments(chip_smoke.zoo_flags(name, jax_run, gif))
    for field in FIELDS:
        assert getattr(args, field) == specs[field], field
        assert type(getattr(args, field)) in (type(specs[field]), float), \
            field
    assert (args.name, args.epochs, args.experiment) == (name, 2, "custom")
    assert args.no_viz_gif is not gif


def test_zoo_covers_the_untested_losses_and_datasets():
    """The three runs train VAE, betaH and betaB once each, on mnist,
    fashion and chairs once each."""
    specs = [chip_smoke.zoo_specs(jax_run)
             for _, jax_run, _ in chip_smoke.ZOO_RUNS]
    assert sorted(s["loss"] for s in specs) == ["VAE", "betaB", "betaH"]
    assert sorted(s["dataset"] for s in specs) == ["chairs", "fashion",
                                                   "mnist"]
    assert set(chip_smoke.ZOO_DATA) == {"mnist", "fashion", "chairs"}
