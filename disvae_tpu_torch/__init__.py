"""disvae_tpu_torch — the PyTorch/CUDA port of disvae_tpu for NVIDIA Hopper.

A second package beside the JAX one (`disvae_tpu`, the reference it is
tested against), with the same module layout: `models/`, `ops/`, `data/`,
`train/`, `utils/`, `serve.py`, `cli.py`. It imports torch and never jax.

Ported so far: serving encode/decode/reconstruct/sample requests
(`serve.ServingModel`); evaluation (`python -m disvae_tpu_torch <name>
--is-eval-only --is-metrics`): test losses, the full-dataset encode, and
the MIG/AAM entropy sweeps through the hand-written CUDA kernel
`ops.log_qz`; and training (`python -m disvae_tpu_torch <name> -d
<dataset> -l <loss> ...`), whose final decoder transposed conv can take
the hand-written backward kernels of `ops.convt_bwd`. The CUDA sources in
`csrc/` are built with nvcc at first use into `build/disvae_tpu_torch/`.
"""

__version__ = "0.1.0"
