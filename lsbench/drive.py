"""Drive the port's ``ServingState`` in process with a closed loop of
clients, and record what happens at each layer boundary.

Every record is taken from the benchmark's side, around the program's
calls: ``prepare`` and ``finish`` (host wall time, the request they
serve), the denoise (``LipsyncPipeline._denoise``: host wall time; in a
traced run a ``record_function`` range around each UNet forward it
makes), the batcher's collection (real windows against the batch it
computes), and the hand-over of output frames to the video writer (time,
count, and for a request submitted once capture is on a copy of the region
the faces are pasted into). A client submits its next request when its
last one completes; its latency runs from ``submit()`` to the job's status
``completed``, read at 5 ms or finer.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

POLL_S = 0.005


@dataclass
class Request:
    n: int
    job_id: str
    seconds: float
    clip: str
    captured: bool
    submitted: float = 0.0
    done: float = 0.0
    status: str = "pending"
    error: str = ""
    frames: int = 0
    timings: dict = field(default_factory=dict)


@dataclass
class Batch:
    t0: float
    t1: float
    computed: int
    real: Optional[int]


class Recorder:
    """What the spies see, under one lock."""

    def __init__(self, crop_region):
        self.lock = threading.Lock()
        self.appends: List[tuple] = []          # (time, job_id, frames)
        self.batches: List[Batch] = []
        self.prepares: Dict[str, tuple] = {}    # job_id -> (t0, t1)
        self.finishes: Dict[str, tuple] = {}
        self.captures: Dict[str, dict] = {}     # job_id -> audio, latents, frames
        self.captured: set = set()              # the requests whose output is kept
        self.capturing = threading.Event()      # set: requests taken from now on are kept
        self.crop = crop_region                 # (y0, y1, x0, x1)
        self.changed = threading.Condition(self.lock)

    def hand_over(self, job_id: str, frames: np.ndarray) -> None:
        t = time.perf_counter()
        crop = None
        if job_id in self.captured:
            y0, y1, x0, x1 = self.crop
            crop = np.array(frames[:, y0:y1, x0:x1])
        with self.lock:
            self.appends.append((t, job_id, len(frames)))
            if crop is not None:
                self.captures.setdefault(job_id, {}).setdefault("frames", []).append(crop)
            self.changed.notify_all()

    def batch_done(self, batch: Batch) -> None:
        with self.lock:
            self.batches.append(batch)
            self.changed.notify_all()

    def wait_batch_end(self, after: float, timeout: float) -> Optional[float]:
        """The end of the first denoise call that ends at or after `after`
        (None when none ends within `timeout` seconds)."""
        deadline = time.perf_counter() + timeout
        with self.lock:
            while True:
                hits = [b.t1 for b in self.batches if b.t1 >= after]
                if hits:
                    return min(hits)
                left = deadline - time.perf_counter()
                if left <= 0:
                    return None
                self.changed.wait(min(left, 0.05))


def _job_of(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


class Spies:
    """Wrap the program's calls for the recorder; `undo()` restores them.
    With a `tracer`, each UNet forward calls its ``at_forward()`` first and
    runs inside a ``record_function`` range ``lsbench.range:unet_forward@<windows>``
    (the windows of the denoise call that makes it), which the traced run
    reads."""

    def __init__(self, pipe, rec: Recorder, tracer=None):
        from latentsync_tpu_torch.pipelines import lipsync

        self.pipe, self.rec = pipe, rec

        self.tl = threading.local()
        self._undo = []
        orig_prepare, orig_finish, orig_denoise = pipe.prepare, pipe.finish, pipe._denoise
        spies = self

        def prepare(*a, **k):
            t0 = time.perf_counter()
            state = orig_prepare(*a, **k)
            spies.tl.prepared = (t0, time.perf_counter(), state.audio_w)
            spies.tl.denoised = []
            return state

        def finish(state, latents, video_out_path, pieces=None):
            job = _job_of(video_out_path)
            t0p, t1p, audio_w = getattr(spies.tl, "prepared", (None, None, None))
            if latents is None:  # the path without the batcher: this thread's denoises
                outs = getattr(spies.tl, "denoised", [])
                latents_seen = torch.cat(outs)[:state.num_windows] if outs else None
            else:
                latents_seen = latents
            with rec.lock:
                rec.prepares[job] = (t0p, t1p)
                if job in rec.captured:
                    cap = rec.captures.setdefault(job, {})
                    cap["audio"] = audio_w
                    cap["latents"] = latents_seen
                    cap["windows"] = state.num_windows
            t0 = time.perf_counter()
            try:
                return orig_finish(state, latents, video_out_path, pieces=pieces)
            finally:
                with rec.lock:
                    rec.finishes[job] = (t0, time.perf_counter())

        def denoise(*a, **k):
            real = getattr(spies.tl, "collected", None)
            spies.tl.collected = None
            spies.tl.windows = int(a[0].shape[0])
            t0 = time.perf_counter()
            out = orig_denoise(*a, **k)
            rec.batch_done(Batch(t0, time.perf_counter(), spies.tl.windows, real))
            if hasattr(spies.tl, "denoised"):
                spies.tl.denoised.append(out)
            return out

        class Writer(lipsync.StreamingVideoWriter):
            def append(self, frames):
                super().append(frames)
                if len(frames):
                    rec.hand_over(_job_of(self.path), frames)

        pipe.prepare, pipe.finish, pipe._denoise = prepare, finish, denoise
        self._undo.append(lambda: [delattr(pipe, n) for n in ("prepare", "finish", "_denoise")])
        if tracer is not None:
            unet, orig_forward = pipe.unet, pipe.unet.forward

            def forward(*a, **k):
                tracer.at_forward()
                label = f"lsbench.range:unet_forward@{getattr(spies.tl, 'windows', 0)}"
                with torch.profiler.record_function(label):
                    return orig_forward(*a, **k)

            unet.forward = forward
            self._undo.append(lambda: delattr(unet, "forward"))
        old_writer = lipsync.StreamingVideoWriter
        lipsync.StreamingVideoWriter = Writer
        self._undo.append(lambda: setattr(lipsync, "StreamingVideoWriter", old_writer))

    def watch_batcher(self, batcher) -> None:
        """Count the real windows of each batch the batcher collects."""
        orig = batcher._collect
        spies = self

        def collect():
            items = orig()
            spies.tl.collected = len(items)
            return items

        batcher._collect = collect

    def undo(self) -> None:
        for fn in reversed(self._undo):
            fn()


class Clients:
    """`count` closed-loop clients over a pool of clips."""

    def __init__(self, state, rec: Recorder, pool, count: int, steps: int, guidance: float):
        self.state, self.rec, self.pool = state, rec, pool
        self.count = count
        self.steps, self.guidance = steps, guidance
        self.stop = threading.Event()
        self.lock = threading.Lock()
        self.next_n = 0
        self.requests: List[Request] = []
        self.completed = threading.Semaphore(0)
        self.threads = [threading.Thread(target=self._run, name=f"lsbench-client-{i}",
                                         daemon=True) for i in range(count)]

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def _take(self) -> Request:
        with self.lock:
            n = self.next_n
            self.next_n += 1
        sec, clip = self.pool[n % len(self.pool)]
        captured = self.rec.capturing.is_set()
        req = Request(n=n, job_id=f"q{n:05d}", seconds=sec, clip=clip, captured=captured)
        if captured:
            with self.rec.lock:
                self.rec.captured.add(req.job_id)
        with self.lock:
            self.requests.append(req)
        return req

    def _run(self) -> None:
        while not self.stop.is_set():
            req = self._take()
            req.submitted = time.perf_counter()
            r = self.state.submit({"job_id": req.job_id, "avatar_id": "avatar",
                                   "audio_path": req.clip, "inference_steps": self.steps,
                                   "guidance_scale": self.guidance})
            if "error" in r:
                req.status, req.error, req.done = "failed", r["error"], time.perf_counter()
                self.completed.release()
                time.sleep(0.05)
                continue
            job = self.state.jobs[req.job_id]
            while job["status"] not in ("completed", "failed"):
                time.sleep(POLL_S)
            req.done = time.perf_counter()
            req.status = job["status"]
            req.error = job.get("error", "")
            req.frames = int(job.get("num_frames") or 0)
            req.timings = dict(job.get("timings") or {})
            out = job.get("output")
            if out:
                for p in (out, os.path.splitext(out)[0] + ".wav"):
                    if os.path.exists(p):
                        os.remove(p)
            self.completed.release()

    def join(self, timeout: float) -> bool:
        deadline = time.perf_counter() + timeout
        for t in self.threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        return not any(t.is_alive() for t in self.threads)
