"""Numeric precision policy (counterpart of disvae_tpu/ops/precision.py).

* ``highest`` — float32 throughout: TF32 off for matmuls AND for cuDNN
  convolutions (cuDNN convs default to TF32 on Ampere and later), and
  deterministic cuDNN algorithms (the default ones for the transposed
  convs add with atomics, so two decodes of one latent differed in the
  last bit on an H100). Parity comparisons and the evaluation CLI run
  here, reproducible run to run as the JAX package is.
* ``high`` — TF32 tensor-core passes for float32 matmuls and convs.
* ``default`` — bf16 autocast around the model's forward (`autocast`
  below); the model casts its outputs back to float32, so losses and
  metrics stay in float32.

The CLI exposes this as ``--precision``.
"""

import torch

PRECISIONS = ["highest", "high", "default"]

# torch's float32 matmul setting stands for the policy: "medium" (bf16
# internal precision) marks ``default``.
_MATMUL = {"highest": "highest", "high": "high", "default": "medium"}


def configure(precision="highest"):
    """Set the process-wide float32 matmul/conv precision."""
    if precision not in PRECISIONS:
        raise ValueError("Unknown precision: {} (choose from {})".format(
            precision, PRECISIONS))
    tf32 = precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = not tf32
    torch.set_float32_matmul_precision(_MATMUL[precision])


def current():
    """The policy `configure` last set (``highest`` before any call)."""
    return {v: k for k, v in _MATMUL.items()}.get(
        torch.get_float32_matmul_precision(), "highest")


def autocast(device_type):
    """bf16 autocast context under ``default``; a disabled one otherwise."""
    return torch.autocast(device_type, dtype=torch.bfloat16,
                          enabled=current() == "default")
