"""The yardstick's arithmetic: the card's published peaks and the work
each kernel and each step needs, computed from shapes alone.

Frozen here, beside the benchmark, so that no change to the program can
move it. The peaks and the bound arithmetic are those `chip_smoke.py`
uses (`PEAK_*`, `_bound`, `_log_qz_bound`, K1/K2's bytes). A new metric
adds its own count in a file of its own and leaves this one as it is.

All times are in seconds.
"""

import math

# One H100 SXM, NVIDIA's data sheet, dense rates, at its 700 W limit:
# device memory bytes/s, bf16 tensor-core FLOP/s, float32 FLOP/s outside
# the tensor cores; the SFU's exps/s, 16 per SM per clock at the 1.98 GHz
# boost clock.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
SMS, EXPS_PER_SM_CLOCK, BOOST_HZ = 132, 16, 1.98e9
PEAK_EXP = SMS * EXPS_PER_SM_CLOCK * BOOST_HZ
# an exp taken on the FMA pipe instead of the SFU: range reduction and a
# degree-6 polynomial, 6 fmas and 3 adds, 15 float32 FLOPs
EXP_FLOPS_ON_FMA = 15
# a Gaussian log-density: the difference, its square, an fma, the sum's
# add (5 FLOPs), and one exp, counted as one more operation
LOG_DENSITY_FLOPS = 6

# the Burgess et al. (2018) model: k4 s2 p1 convs of 32 channels, two
# 256-unit linears, a 2 * latent head; the decoder mirrors it
HID, KERNEL, HIDDEN = 32, 4, 256


def bound_s(nbytes, ops=()):
    """The least time of a kernel: its bytes (each input read once, each
    output written once) over the memory rate, against each (count, peak
    rate) of its operations. Returns (seconds, "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max((n / rate for n, rate in ops), default=0.0)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fma_exp_share():
    """The share f of exps K3 takes on the FMA pipe that balances the SFU
    and the FMA pipe: n (1 - f) / PEAK_EXP = n (5 + 15 f) / PEAK_F32."""
    f = ((PEAK_F32 - 5 * PEAK_EXP)
         / (PEAK_F32 + EXP_FLOPS_ON_FMA * PEAK_EXP))
    return min(1.0, max(0.0, f))


def log_qz_bound_s(n, nbytes):
    """K3's least time for n log-densities (5 FLOPs and one exp each, the
    exps split between the SFU and the FMA pipe at `fma_exp_share`)."""
    f = fma_exp_share()
    return bound_s(nbytes, [(n * (1 - f), PEAK_EXP),
                            (n * (5 + EXP_FLOPS_ON_FMA * f), PEAK_F32)])[0]


def convt3_shapes(batch, img_size):
    """(x, dy, w) shapes of the final decoder transposed conv: x (B, 32,
    H/2, W/2) -> dy (B, C, H, W), w (32, C, 4, 4)."""
    c, h, w = img_size
    return ((batch, HID, h // 2, w // 2), (batch, c, h, w),
            (HID, c, KERNEL, KERNEL))


def _numel(shape):
    return math.prod(shape)


def k1_bytes(batch, img_size):
    """K1 (dW) reads x and dy in bf16 and writes dW in float32."""
    x, dy, w = convt3_shapes(batch, img_size)
    return 2 * (_numel(x) + _numel(dy)) + 4 * _numel(w)


def k2_bytes(batch, img_size):
    """K2 (dx) with float32 dx, the `default` numerics' K2: reads dy in
    bf16 and w in float32, writes dx in float32."""
    x, dy, w = convt3_shapes(batch, img_size)
    return 2 * _numel(dy) + 4 * (_numel(x) + _numel(w))


def convt3_flops(batch, img_size):
    """The final convT's multiply-adds, on the bf16 tensor cores."""
    x, dy, w = convt3_shapes(batch, img_size)
    return 2 * _numel(x) * KERNEL * KERNEL * dy[1]


def k1_bound_s(batch, img_size):
    return bound_s(k1_bytes(batch, img_size),
                   [(convt3_flops(batch, img_size), PEAK_BF16)])[0]


def k2_bound_s(batch, img_size):
    return bound_s(k2_bytes(batch, img_size),
                   [(convt3_flops(batch, img_size), PEAK_BF16)])[0]


def layer_macs(img_size, latent_dim):
    """Multiply-adds per image of each layer of the Burgess VAE, encoder
    then decoder, as (name, MACs); biases and activations not counted."""
    c, h, _ = img_size
    layers = []
    cin, size = c, h
    names = ["conv1", "conv2", "conv3"] + (["conv_64"] if h == 64 else [])
    for name in names:  # each conv halves the side
        size //= 2
        layers.append(("encoder." + name,
                       size * size * HID * cin * KERNEL * KERNEL))
        cin = HID
    flat = HID * 4 * 4
    layers += [("encoder.lin1", flat * HIDDEN),
               ("encoder.lin2", HIDDEN * HIDDEN),
               ("encoder.mu_logvar_gen", HIDDEN * 2 * latent_dim),
               ("decoder.lin1", latent_dim * HIDDEN),
               ("decoder.lin2", HIDDEN * HIDDEN),
               ("decoder.lin3", HIDDEN * flat)]
    size = 4
    names = (["convT_64"] if h == 64 else []) + ["convT1", "convT2",
                                                 "convT3"]
    for i, name in enumerate(names):  # each transposed conv doubles it
        cout = c if i == len(names) - 1 else HID
        layers.append(("decoder." + name,
                       size * size * HID * cout * KERNEL * KERNEL))
        size *= 2
    return layers


def forward_flops(img_size, latent_dim, part=""):
    """FLOPs (2 per multiply-add) of one image's forward pass through the
    layers whose name starts with `part` ("encoder." for the encode)."""
    return 2 * sum(m for n, m in layer_macs(img_size, latent_dim)
                   if n.startswith(part))


def train_flops_per_image(img_size, latent_dim):
    """A training step's FLOPs per image: the forward, and in the backward
    each layer's dgrad and wgrad (as many multiply-adds as its forward
    each), but no dgrad of conv1, whose input is the data."""
    conv1 = dict(layer_macs(img_size, latent_dim))["encoder.conv1"]
    return 3 * forward_flops(img_size, latent_dim) - 2 * conv1


def mig_sweeps(lat_sizes, n_samples=10000, chunk=2000):
    """The log_qz launches of one MIG/AAM eval over a full factor lattice:
    the marginal sweep (L = 1, M = N), then one sweep per factor (its L
    slices batched, M = N / L); each sweep in chunks of `chunk` samples.
    Returns [(L, M, S_chunk)], one entry per launch."""
    n = math.prod(lat_sizes)
    launches = []
    for L in [1] + list(lat_sizes):
        m = n // L
        s = min(n_samples, m)
        launches += [(L, m, min(chunk, s - s0)) for s0 in range(0, s, chunk)]
    return launches


def mig_log_densities(lat_sizes, latent_dim, n_samples=10000, chunk=2000):
    """Log-densities one MIG/AAM eval needs, whatever computes them."""
    return sum(L * m * latent_dim * s
               for L, m, s in mig_sweeps(lat_sizes, n_samples, chunk))


def k3_bound_s(lat_sizes, latent_dim, n_samples=10000, chunk=2000):
    """K3's least time over the launches of one eval, each launch's bytes
    its inputs (values, mu, logvar) and output once, in float32."""
    total = 0.0
    for L, m, s in mig_sweeps(lat_sizes, n_samples, chunk):
        n = L * m * latent_dim * s
        nbytes = 4 * (2 * L * m * latent_dim + 2 * L * latent_dim * s)
        total += log_qz_bound_s(n, nbytes)
    return total


def mig_eval_flops(lat_sizes, img_size, latent_dim, n_samples=10000,
                   chunk=2000):
    """The work a MIG/AAM eval needs: the encoder's forward over every
    image of the lattice, plus LOG_DENSITY_FLOPS per log-density."""
    n = math.prod(lat_sizes)
    return (n * forward_flops(img_size, latent_dim, "encoder.")
            + LOG_DENSITY_FLOPS * mig_log_densities(lat_sizes, latent_dim,
                                                    n_samples, chunk))
