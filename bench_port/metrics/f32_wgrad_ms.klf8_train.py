"""Device milliseconds per step in the float32 (TF32 off) kernels of the
thin layers' backward, over the traced window's steps: the route the
precision policy sends a thin layer's weight gradient to (counted as
`wgrad.f32`), on which cuDNN also computes the layer's input gradient. On the H100 cuDNN
takes the encoder's conv_in with `wgrad_alg1_engine`, the decoder's
conv_in and conv_out with non-fused Winograd and its float32 GEMMs, and
post_quant_conv with its direct kernel; every float32 xmma kernel
(`f32f32_f32f32_f32`, TF32's being `f32f32_tf32f32_f32`) of the step is
one of these layers' (klf8_kernels.py)."""

from devtrace import kernel_time

KERNELS = ("wgrad_alg1_engine", "winogradWgrad", "wgrad2d_grouped_direct",
           "f32f32_f32f32_f32")


def read(cell):
    if cell.summary is None or not cell.work.get("steps"):
        return None
    seconds, _ = kernel_time(cell.summary, *KERNELS)
    return 1e3 * seconds / cell.work["steps"] if seconds else None
