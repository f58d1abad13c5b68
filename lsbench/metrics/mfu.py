"""The least time the card needs for every product of the window's
completed work, over the window's time: the denoise of each window the
completed batches held for requests (on the configuration's schedule:
DeepCache reads count their partial forward, steps outside the guidance
interval their half batch), the VAE decode of every frame handed over, the
whisper segments of every request prepared. Products in the served type at
its peak, int8 convolutions at the int8 peak (``counts/schedule.py``,
``counts/peaks.json``)."""

from lsbench.counts.schedule import ideal_seconds, per_unit


def read(run):
    if run["peaks"] is None or run["window_s"] <= 0:
        return None
    units = per_unit(run["config"])
    windows = sum(b.real if b.real is not None else b.computed for b in run["batches"])
    ideal = (windows * ideal_seconds(units["denoise_window"], run["peaks"])
             + run["frames"] * ideal_seconds(units["decode_frame"], run["peaks"])
             + run["segments"] * ideal_seconds(units["whisper_segment"], run["peaks"]))
    return 100.0 * ideal / run["window_s"] if ideal > 0 else None
