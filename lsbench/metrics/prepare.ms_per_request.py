"""Host wall time of ``LipsyncPipeline.prepare`` per request (the avatar's
full-video read, the bundle and its latents, whisper), over the requests
completed in the window."""


def read(run):
    spans = [run["prepares"][r.job_id] for r in run["completed"] if r.job_id in run["prepares"]]
    spans = [(a, b) for a, b in spans if a is not None]
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
