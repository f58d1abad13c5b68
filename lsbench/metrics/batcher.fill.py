"""Windows the batcher filled with requests' windows over the windows its
device batches computed (a short batch is padded: padding is waste), over
the batches that completed in the window. Nothing without a batcher."""


def read(run):
    batches = [b for b in run["batches"] if b.real is not None]
    if not batches:
        return None
    return 100.0 * sum(b.real for b in batches) / sum(b.computed for b in batches)
