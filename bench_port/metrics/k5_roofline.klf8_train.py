"""K5 (GroupNorm -> SiLU -> bf16 rounding, the `GroupNormSiLU` kernels)
against its compulsory bytes: five float32 passes over the input of
every GroupNorm -> SiLU site of kl-f8 (x read and y written forward, dy
and x read and dx written backward) at 3.35 TB/s, over the device time
of K5's kernels, per traced step. The sites are counted from the
configuration's widths here, so the bytes are the same whatever computes
them: every ResnetBlock's two norms and both `conv_norm_out`s, 50 sites
and 698 MB of float32 input a 256^2 image at the published widths; the
attention's GroupNorms feed no SiLU and are not counted."""

from devtrace import kernel_time

# sd-vae-ft-mse's widths (its config.json), as roofline_klf8.py has them
PUBLISHED = {"block_out_channels": (128, 256, 512, 512),
             "layers_per_block": 2}
PASSES = 5
PEAK_BYTES = 3.35e12  # one H100 SXM's HBM3 at 700 W


def site_elements(img_size, block_out_channels=None, layers_per_block=None):
    """Elements of one image's input to each GroupNorm -> SiLU site."""
    widths = tuple(block_out_channels or PUBLISHED["block_out_channels"])
    nl = int(layers_per_block or PUBLISHED["layers_per_block"])
    side = img_size[1] * img_size[2]
    out = []

    def resnet(cin, cout, area):
        out.extend([cin * area, cout * area])

    for i, c in enumerate(widths):  # the encoder's levels
        for j in range(nl):
            resnet(widths[max(i - 1, 0)] if j == 0 else c, c, side)
        if i < len(widths) - 1:
            side //= 4
    for _ in range(2):  # its mid block, conv_norm_out
        resnet(widths[-1], widths[-1], side)
    out.append(widths[-1] * side)
    rev = widths[::-1]
    for _ in range(2):  # the decoder's mid block
        resnet(rev[0], rev[0], side)
    for i, c in enumerate(rev):
        for j in range(nl + 1):
            resnet(rev[max(i - 1, 0)] if j == 0 else c, c, side)
        if i < len(rev) - 1:
            side *= 4
    out.append(rev[-1] * side)  # conv_norm_out
    return out


def read(cell):
    if cell.summary is None or "batches" not in cell.work:
        return None
    seconds, _ = kernel_time(cell.summary, "GroupNormSiLU")
    if not seconds:
        return None
    cfg = cell.config
    arch = {k: cfg[k] for k in PUBLISHED if k in cfg}
    per_image = sum(site_elements(tuple(cfg["img_size"]), **arch))
    images = sum(b * n for b, n in cell.work["batches"].items())
    bound_s = PASSES * 4 * per_image * images / PEAK_BYTES
    return 100 * bound_s / seconds
