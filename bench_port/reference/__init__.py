"""Plain PyTorch and NumPy references of what the benchmark's cells run.

Written from the published layer equations (Burgess et al. 2018,
arXiv:1804.03599), the beta-TCVAE loss (Chen et al. 2018,
arXiv:1802.04942) and the MIG/AAM estimator of the reference repository
(YannDubs/disentangling-vae), with its conventions kept. Nothing here
imports the program under test, JAX or the JAX package, and nothing here
reads what the program made: the benchmark hands both sides the same
inputs, weights and seeds.
"""
