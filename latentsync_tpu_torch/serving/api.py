"""HTTP lip-sync server: POST /process, GET /jobs/<id>, GET /ping.

Counterpart of ``latentsync_tpu/serving/api.py``: a bounded job queue (429
when full). By default ONE worker thread drains it and owns the GPU, a
whole request at a time. With ``continuous_batching`` several workers
(at least 2) each run a request's ``prepare`` and ``finish``, and the
request's 16-frame windows go to a ``WindowBatcher`` (``batcher.py``), one
per (steps, guidance), whose thread denoises windows of concurrent
requests in shared batches of ``batch_windows``. Avatars resolve to
pre-uploaded videos with their precomputed affine bundles
(``prepare_video``); an avatar without one runs the FAN face path in its
request.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict

import torch

from .artifacts import AvatarStore


class ServingState:
    def __init__(self, pipeline, avatar_store: AvatarStore, out_dir: str,
                 max_queue: int = 10, continuous_batching: bool = False,
                 batch_windows: int = 2, num_workers: int = 2):
        self.pipeline = pipeline
        self.avatars = avatar_store
        self.out_dir = out_dir
        self.jobs: Dict[str, dict] = {}
        self.queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        os.makedirs(out_dir, exist_ok=True)
        self.continuous_batching = continuous_batching
        self.batch_windows = batch_windows
        self._batchers: Dict[tuple, object] = {}
        self._batchers_lock = threading.Lock()
        if continuous_batching:
            self._get_batcher(20, 1.5)  # the default operating point, ready at start
            workers = max(num_workers, 2)
        else:
            workers = 1  # one request owns the GPU at a time
        self._workers = [threading.Thread(target=self._drain, name=f"serving-worker-{i}",
                                          daemon=True) for i in range(workers)]
        for t in self._workers:
            t.start()

    def _get_batcher(self, steps: int, guidance: float):
        """The batcher of one (steps, guidance), made at first use: windows
        share device batches only with windows of the same setting."""
        key = (int(steps), float(guidance))
        with self._batchers_lock:
            batcher = self._batchers.get(key)
            if batcher is None:
                from .batcher import WindowBatcher, make_denoise_batch_fn

                batcher = WindowBatcher(make_denoise_batch_fn(self.pipeline, *key),
                                        max_windows=self.batch_windows)
                self._batchers[key] = batcher
            return batcher

    def submit(self, request: dict) -> dict:
        job_id = request.get("job_id") or uuid.uuid4().hex
        job = {"job_id": job_id, "status": "pending", "request": request,
               "submitted": time.time()}
        try:
            self.queue.put_nowait(job)
        except queue.Full:
            return {"error": "queue full", "code": 429}
        self.jobs[job_id] = job
        return {"job_id": job_id, "status": "pending"}

    def _drain(self):
        while True:
            job = self.queue.get()
            if job is None:
                return
            job["status"] = "running"
            t0 = time.time()
            try:
                req = job["request"]
                avatar = self.avatars.resolve(req["avatar_id"],
                                              rotated=req.get("rotated", False),
                                              darken=req.get("darken", False))
                out_path = os.path.join(self.out_dir, f"{job['job_id']}.mp4")
                steps = req.get("inference_steps", 20)
                guidance = req.get("guidance_scale", 1.5)
                if self.continuous_batching:
                    result = self._run_batched(avatar, req["audio_path"], out_path, steps,
                                               guidance)
                else:
                    result = self.pipeline(
                        video_path=avatar.video_path, audio_path=req["audio_path"],
                        video_out_path=out_path, data_path=avatar.bundle_path,
                        num_inference_steps=steps, guidance_scale=guidance)
                job.update(status="completed", output=result.video_path,
                           num_frames=result.num_frames, elapsed=time.time() - t0,
                           timings=result.elapsed,
                           restore_route=getattr(result, "restore_route", None))
            except Exception as e:  # noqa: BLE001 — one failed job must not stop the worker
                traceback.print_exc()
                job.update(status="failed", error=f"{type(e).__name__}: {e}",
                           elapsed=time.time() - t0)

    def _run_batched(self, avatar, audio_path, out_path, steps, guidance):
        """One request on the continuous-batching path: ``prepare``, one
        future a window from the (steps, guidance) batcher (its batches may
        hold other requests' windows), the stacked latents to ``finish``."""
        batcher = self._get_batcher(steps, guidance)
        pipe = self.pipeline
        state = pipe.prepare(video_path=avatar.video_path, audio_path=audio_path,
                             data_path=avatar.bundle_path)
        futures = [batcher.submit({"latents0": state.latents0[i], "mask": state.mask_w[i],
                                   "masked": state.masked_lat_w[i], "ref": state.ref_lat_w[i],
                                   "audio": state.audio_w[i]})
                   for i in range(state.num_windows)]
        latents = torch.stack([f.result() for f in futures])
        return pipe.finish(state, latents, out_path)

    def shutdown(self, timeout: float = 60.0) -> None:
        """Stop the workers after the jobs already queued, then the
        batchers."""
        for _ in self._workers:
            self.queue.put(None)
        for t in self._workers:
            t.join(timeout)
        with self._batchers_lock:
            for batcher in self._batchers.values():
                batcher.close(timeout)


def make_handler(state: ServingState):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/ping":
                self._send(200, {"status": "ok", "queued": state.queue.qsize()})
            elif self.path.startswith("/jobs/"):
                job = state.jobs.get(self.path.split("/")[-1])
                if job is None:
                    self._send(404, {"error": "unknown job"})
                else:
                    self._send(200, {k: v for k, v in job.items() if k != "request"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/process":
                self._send(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._send(400, {"error": "invalid JSON"})
                return
            if "avatar_id" not in req or "audio_path" not in req:
                self._send(400, {"error": "avatar_id and audio_path required"})
                return
            result = state.submit(req)
            if "error" in result:
                self._send(result.pop("code", 500), result)
            else:
                self._send(200, result)

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler



def serve(pipeline, avatar_store: AvatarStore, out_dir: str, host: str = "0.0.0.0",
          port: int = 8000, continuous_batching: bool = False, batch_windows: int = 8,
          num_workers: int = 2) -> None:
    """Serve `pipeline` over HTTP until interrupted, then stop the workers."""
    state = ServingState(pipeline, avatar_store, out_dir,
                         continuous_batching=continuous_batching,
                         batch_windows=batch_windows, num_workers=num_workers)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    print(f"serving on {host}:{port} (continuous_batching={continuous_batching})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        state.shutdown()
