"""FactorVAE total-correlation discriminator (Kim & Mnih 2018, Alg. 2).

Counterpart of disvae_tpu/models/discriminator.py (reference
disvae/models/discriminator.py:10-73): a 6-layer MLP with 1000 hidden
units and LeakyReLU(0.2), emitting 2 logits. Every weight gets the
kaiming-uniform relu init that the reference applies blindly
(models/initialization.py), biases torch's default. Its layers run under
the precision policy (ops/precision.py `Linear`), as JAX's call
`disvae_tpu.ops.convs.linear`.
"""

import torch.nn.functional as F
from torch import nn

from disvae_tpu_torch.models.initialization import weights_init
from disvae_tpu_torch.ops.precision import Linear

N_LAYERS = 6


class Discriminator(nn.Module):
    """z (B, latent_dim) -> logits (B, 2); layers `lin1` ... `lin6`."""

    def __init__(self, latent_dim=10, hidden_units=1000, neg_slope=0.2,
                 out_units=2, generator=None):
        super().__init__()
        self.latent_dim = latent_dim
        self.neg_slope = neg_slope
        dims = ([latent_dim] + [hidden_units] * (N_LAYERS - 1)
                + [out_units])
        for i in range(N_LAYERS):
            setattr(self, "lin{}".format(i + 1),
                    Linear(dims[i], dims[i + 1]))
        weights_init(self, generator)

    def forward(self, z):
        h = z
        for i in range(1, N_LAYERS):
            h = F.leaky_relu(getattr(self, "lin{}".format(i))(h),
                             self.neg_slope)
        return getattr(self, "lin{}".format(N_LAYERS))(h)
