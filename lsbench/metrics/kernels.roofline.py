"""The model operations' share of their roofline: the sum over every call
of the least time its work needs (operations over the peak of its
precision, or bytes read and written once over the HBM rate, the larger),
over the sum of the device time of the kernels launched inside the calls,
over the traced part of the window, for the calls made on the traced
thread, the one that runs the UNet's forwards (with the batcher, the
UNet's operations). Counted per operation (``counts/entries``), whatever
kernels carry it."""


def read(run):
    tr, peaks = run["trace"], run["peaks"]
    if not tr or peaks is None:
        return None
    bound = dev = 0.0
    for _, prec, ops, moved, seconds in tr["entries"]:
        if seconds <= 0:
            continue
        bound += max(ops / peaks[prec], moved / peaks["hbm_bytes_per_s"])
        dev += seconds
    if dev <= 0:
        return None
    return 100.0 * bound / dev
