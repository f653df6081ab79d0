"""disvae_tpu_torch — the PyTorch/CUDA port of disvae_tpu for NVIDIA Hopper.

A second package beside the JAX one (`disvae_tpu`, the reference it is
tested against), with the same module layout: `models/`, `ops/`, `data/`,
`train/`, `utils/`, `parallel/`, `native/`, `serve.py`, `cli.py`,
`cli_viz.py`. It imports torch and never jax.

Ported so far: serving encode/decode/reconstruct/sample requests
(`serve.ServingModel`) and `torch.export` artifacts (`python -m
disvae_tpu_torch.serve <name>`); evaluation (`python -m disvae_tpu_torch
<name> --is-eval-only --is-metrics`): test losses, the full-dataset
encode, and the MIG/AAM entropy sweeps through the hand-written CUDA
kernel `ops.log_qz`; training (`python -m disvae_tpu_torch <name> -d
<dataset> -l <loss> ...`) with its per-epoch traversal gif, whose final
decoder transposed conv can take the hand-written backward kernels of
`ops.convt_bwd`; and the plots (`python -m disvae_tpu_torch.cli_viz
<name> all`). Data parallelism over torch.distributed (`parallel/`,
`torchrun --nproc_per_node N -m disvae_tpu_torch ...`) computes every
loss at the global batch; `--model-parallel M` puts the FactorVAE
discriminator column-parallel over groups of M ranks. The CUDA sources in
`csrc/` are built with nvcc, and the native host gather of `native/` with
g++, at first use into `build/disvae_tpu_torch/`.
"""

__version__ = "0.1.0"
