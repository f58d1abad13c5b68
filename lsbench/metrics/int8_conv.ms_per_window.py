"""Device time of the kernels launched inside the int8 convolution route
(``ops/qconv.py`` ``quantized_conv2d``: quantize passes, im2col,
``torch._int_mm``, dequantisation) on the traced thread, the one that
runs the UNet's forwards (with the batcher, the UNet's convolutions
alone; the VAE decode's run on the requests' threads), per window the
traced forwards denoised (as ``denoise.device_ms_per_window`` counts
them: the trace starts and stops between two forwards). Nothing where the
route does not run."""

RANGES = {"int8_conv": ["latentsync_tpu_torch.ops.qconv:quantized_conv2d"]}


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    calls, dev, _ = tr["ranges"].get("int8_conv", (0, 0.0, 0.0))
    windows = tr["ranges"].get("unet_forward", (0, 0.0, 0.0))[2] / run["config"]["inference_steps"]
    if not calls or windows <= 0 or dev <= 0:
        return None
    return 1e3 * dev / windows
