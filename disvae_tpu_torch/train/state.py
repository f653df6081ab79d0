"""Training state (disvae_tpu/train/state.py).

What the reference kept as object state — the model, its Adam, the
FactorVAE discriminator and its own Adam, the `n_train_steps` counter —
plus the generator that draws the training noise and the loss's
coefficient vector, in one object. `state_dict()` / `load_state_dict()`
carry everything a bit-exact resume needs.

Under tensor parallelism (parallel/mesh.py `shard_train_state`) the
discriminator and its Adam hold this rank's shards, while `state_dict()`
still returns the WHOLE discriminator and its moments, gathered over the
model group (every rank of it must call it), and `load_state_dict()`
slices a whole one again: a checkpoint resumes at any model size.
"""

from dataclasses import dataclass

import torch

from disvae_tpu_torch.ops.losses import coef_vector
from disvae_tpu_torch.parallel.mesh import (load_whole_disc_state,
                                            whole_disc_state)


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    # draws the reparameterization noise and FactorVAE's permutations; it
    # lives on the model's device, so a step never waits on the host
    generator: torch.Generator
    step: int = 0  # counted like the reference's n_train_steps
    disc: torch.nn.Module = None
    disc_optimizer: torch.optim.Optimizer = None
    # the loss's sweepable coefficients (ops/losses.py coef_vector) on the
    # device; a pure function of the loss config, so never checkpointed
    coefs: torch.Tensor = None
    # the mesh whose model group shards `disc` column-parallel, or None
    # for a replicated discriminator
    disc_mesh: object = None

    def state_dict(self):
        sd = {"model": self.model.state_dict(),
              "optimizer": self.optimizer.state_dict(),
              "generator": self.generator.get_state(),
              "step": self.step}
        if self.disc_mesh is not None:
            sd["disc"], sd["disc_optimizer"] = whole_disc_state(
                self.disc, self.disc_optimizer, self.disc_mesh)
        elif self.disc is not None:
            sd["disc"] = self.disc.state_dict()
            sd["disc_optimizer"] = self.disc_optimizer.state_dict()
        return sd

    def load_state_dict(self, sd):
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.generator.set_state(sd["generator"].cpu())
        self.step = int(sd["step"])
        if self.disc_mesh is not None:
            load_whole_disc_state(self.disc, self.disc_optimizer,
                                  self.disc_mesh, sd["disc"],
                                  sd["disc_optimizer"])
        elif self.disc is not None:
            self.disc.load_state_dict(sd["disc"])
            self.disc_optimizer.load_state_dict(sd["disc_optimizer"])


def create_train_state(model, optimizer, generator, disc=None,
                       disc_optimizer=None, loss_cfg=None):
    device = next(model.parameters()).device
    coefs = None if loss_cfg is None else coef_vector(loss_cfg, device=device)
    return TrainState(model=model, optimizer=optimizer, generator=generator,
                      disc=disc, disc_optimizer=disc_optimizer, coefs=coefs)
