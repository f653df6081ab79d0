"""The work of Stable Diffusion's kl-f8 autoencoder, counted from shapes
alone and frozen here beside the benchmark, so that no change to the
program can move it.

A forward pass's FLOPs are 2 per multiply-add of every conv, every
linear of the attention and the attention's two products (q k^T and its
weighted sum of v); GroupNorm, SiLU, the softmax, the resampling and the
loss are not counted. A training step computes each of them three times
(the forward, the input gradient and the weight gradient, or the two
operands' gradients of a product), but for the input gradient of the
encoder's `conv_in`, whose input is the data.
"""

# sd-vae-ft-mse's widths (its config.json)
PUBLISHED = {"block_out_channels": (128, 256, 512, 512),
             "layers_per_block": 2, "latent_channels": 4}


def layer_macs(img_size, block_out_channels=None, layers_per_block=None,
               latent_channels=None):
    """[(name, multiply-adds per image)] of every conv, linear and
    attention product, encoder then decoder."""
    widths = tuple(block_out_channels or PUBLISHED["block_out_channels"])
    nl = int(layers_per_block or PUBLISHED["layers_per_block"])
    lc = int(latent_channels or PUBLISHED["latent_channels"])
    c_img, h, w = img_size
    out = []

    def conv(name, cin, cout, k, side):
        out.append((name, side[0] * side[1] * cout * cin * k * k))

    def resnet(name, cin, cout, side):
        conv(name + ".conv1", cin, cout, 3, side)
        conv(name + ".conv2", cout, cout, 3, side)
        if cin != cout:
            conv(name + ".conv_shortcut", cin, cout, 1, side)

    def mid(name, c, side):
        p = side[0] * side[1]
        resnet(name + ".resnets.0", c, c, side)
        for proj in ("to_q", "to_k", "to_v", "to_out.0"):
            out.append((name + ".attentions.0." + proj, p * c * c))
        out.append((name + ".attentions.0.qk", p * p * c))
        out.append((name + ".attentions.0.pv", p * p * c))
        resnet(name + ".resnets.1", c, c, side)

    side = (h, w)
    conv("encoder.conv_in", c_img, widths[0], 3, side)
    for i, c in enumerate(widths):
        for j in range(nl):
            resnet("encoder.down_blocks.{}.resnets.{}".format(i, j),
                   widths[max(i - 1, 0)] if j == 0 else c, c, side)
        if i < len(widths) - 1:
            side = (side[0] // 2, side[1] // 2)
            conv("encoder.down_blocks.{}.downsamplers.0.conv".format(i), c,
                 c, 3, side)
    mid("encoder.mid_block", widths[-1], side)
    conv("encoder.conv_out", widths[-1], 2 * lc, 3, side)
    conv("quant_conv", 2 * lc, 2 * lc, 1, side)
    conv("post_quant_conv", lc, lc, 1, side)
    rev = widths[::-1]
    conv("decoder.conv_in", lc, rev[0], 3, side)
    mid("decoder.mid_block", rev[0], side)
    for i, c in enumerate(rev):
        for j in range(nl + 1):
            resnet("decoder.up_blocks.{}.resnets.{}".format(i, j),
                   rev[max(i - 1, 0)] if j == 0 else c, c, side)
        if i < len(rev) - 1:
            side = (side[0] * 2, side[1] * 2)
            conv("decoder.up_blocks.{}.upsamplers.0.conv".format(i), c, c,
                 3, side)
    conv("decoder.conv_out", rev[-1], c_img, 3, side)
    return out


def forward_flops(img_size, **arch):
    """FLOPs of one image's forward pass."""
    return 2 * sum(m for _, m in layer_macs(img_size, **arch))


def train_flops_per_image(img_size, **arch):
    """A training step's FLOPs per image: three times the forward's, less
    the input gradient of `encoder.conv_in`."""
    conv_in = dict(layer_macs(img_size, **arch))["encoder.conv_in"]
    return 3 * forward_flops(img_size, **arch) - 2 * conv_in
