"""Device time of the kernels launched inside the UNet's forwards
(``record_function`` ranges the drive opens around each forward of the
denoise in a traced run), per window denoised: each forward counts as the
windows of its denoise call over the configuration's steps, since the
denoise makes one forward a step. Only the forwards that ran wholly inside
the traced part of the window count, on either side of the quotient.
Kernels other threads launch meanwhile (whisper, the decode, the restore)
are not inside; the DDIM update and the guidance's combination between
forwards are left out. Nothing where no forward was traced."""


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    calls, dev, weight = tr["ranges"].get("unet_forward", (0, 0.0, 0.0))
    windows = weight / run["config"]["inference_steps"]
    if not calls or windows <= 0 or dev <= 0:
        return None
    return 1e3 * dev / windows
