"""The restoring thread's and the video writer's busy time (``JobState``
timings ``restore`` + ``write``) per output frame, over the requests
completed in the window."""


def read(run):
    done = [r for r in run["completed"] if "restore" in r.timings and "write" in r.timings]
    frames = sum(r.frames for r in done)
    if not frames:
        return None
    return 1e3 * sum(r.timings["restore"] + r.timings["write"] for r in done) / frames
