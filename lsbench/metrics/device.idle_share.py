"""The share of the traced part of the window in which no kernel ran on
the device: one minus the union of the profiler's kernel intervals over
the traced time."""


def read(run):
    tr = run["trace"]
    if not tr or "busy_s" not in tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
