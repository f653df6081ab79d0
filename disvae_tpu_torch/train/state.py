"""Training state (disvae_tpu/train/state.py).

What the reference kept as object state — the model, its Adam, the
FactorVAE discriminator and its own Adam, the `n_train_steps` counter —
plus the generator that draws the training noise and the loss's
coefficient vector, in one object. `state_dict()` / `load_state_dict()`
carry everything a bit-exact resume needs.

The step is counted twice: `step`, a Python int the host reads (the
record gate, checkpoints), and `device_step`, a 0-d int64 tensor on the
model's device that the losses read, as JAX carries `step` in its state.
A step increments both; a replayed CUDA graph of K steps increments the
device counter inside the graph and the host adds K (train/steps.py
`GraphedSuperStep`). They agree after every step and after a load.

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
    # the same count on the model's device (0-d int64), read by the losses
    device_step: torch.Tensor = None
    disc: torch.nn.Module = None
    disc_optimizer: torch.optim.Optimizer = None
    # the loss's sweepable coefficients (ops/losses.py coef_vector) on the
    # device; a pure function of the loss config, so never checkpointed
    coefs: torch.Tensor = None
    # the mesh whose model group shards `disc` column-parallel, or None
    # for a replicated discriminator
    disc_mesh: object = None

    def state_dict(self):
        device_step = self.device_step.cpu()  # waits for the device
        if int(device_step) != self.step:
            raise RuntimeError("the device step counter ({}) disagrees with "
                               "the host's ({})".format(int(device_step),
                                                        self.step))
        sd = {"model": self.model.state_dict(),
              "optimizer": self.optimizer.state_dict(),
              "generator": self.generator.get_state(),
              "step": self.step, "device_step": device_step}
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
        device_step = int(sd.get("device_step", self.step))
        if device_step != self.step:
            raise ValueError("checkpoint step counters disagree: device {}, "
                             "host {}".format(device_step, self.step))
        # in place: a captured graph keeps reading the same tensor
        self.device_step.fill_(device_step)
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
                      device_step=torch.zeros((), dtype=torch.int64,
                                              device=device),
                      disc=disc, disc_optimizer=disc_optimizer, coefs=coefs)
