"""Weight initialisation with the PyTorch reference's conventions
(disvae_tpu/models/initialization.py; reference
disvae/utils/initialization.py:33-61).

Every conv / transposed-conv / linear weight gets kaiming-uniform with the
relu gain, U(-sqrt(6 / fan_in), sqrt(6 / fan_in)); biases keep torch's
module default U(-1/sqrt(fan_in), 1/sqrt(fan_in)). fan_in follows torch's
rule, size(1) * kernel area:

  * Linear (out, in):                      fan_in = in
  * Conv2d (out, in, kh, kw):              fan_in = in * kh * kw
  * ConvTranspose2d (in, out, kh, kw):     fan_in = out * kh * kw — size(1)
    is the OUT channel count for transposed convs, a quirk kept on purpose
    (disvae_tpu/models/initialization.py:13-17).

Draws come from an explicit `torch.Generator`.
"""

import math

from torch import nn

_LAYERS = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)


def fan_in(weight):
    """torch's fan_in: size(1) times the kernel area."""
    return weight.shape[1] * math.prod(weight.shape[2:])


def weights_init(module, generator=None):
    """Initialise every conv / linear layer under `module` in place."""
    for layer in module.modules():
        if isinstance(layer, _LAYERS):
            n = fan_in(layer.weight)
            bound = math.sqrt(6.0 / n)
            layer.weight.data.uniform_(-bound, bound, generator=generator)
            if layer.bias is not None:
                b = 1.0 / math.sqrt(n)
                layer.bias.data.uniform_(-b, b, generator=generator)
