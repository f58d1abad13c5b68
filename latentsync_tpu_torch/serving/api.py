"""HTTP lip-sync server: POST /process, GET /jobs/<id>, GET /ping.

Counterpart of ``latentsync_tpu/serving/api.py`` in its non-batched mode:
a bounded job queue (429 when full) drained by ONE worker thread that
owns the GPU. Avatars resolve to pre-uploaded videos with precomputed
affine bundles, so serving runs no face detection.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler
from typing import Dict

from .artifacts import AvatarStore


class ServingState:
    def __init__(self, pipeline, avatar_store: AvatarStore, out_dir: str,
                 max_queue: int = 10):
        self.pipeline = pipeline
        self.avatars = avatar_store
        self.out_dir = out_dir
        self.jobs: Dict[str, dict] = {}
        self.queue: "queue.Queue" = queue.Queue(maxsize=max_queue)
        os.makedirs(out_dir, exist_ok=True)
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

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
                result = self.pipeline(
                    video_path=avatar.video_path, audio_path=req["audio_path"],
                    video_out_path=os.path.join(self.out_dir, f"{job['job_id']}.mp4"),
                    data_path=avatar.bundle_path,
                    num_inference_steps=req.get("inference_steps", 20),
                    guidance_scale=req.get("guidance_scale", 1.5))
                job.update(status="completed", output=result.video_path,
                           num_frames=result.num_frames, elapsed=time.time() - t0,
                           timings=result.elapsed)
            except Exception as e:  # noqa: BLE001 — one failed job must not stop the worker
                traceback.print_exc()
                job.update(status="failed", error=f"{type(e).__name__}: {e}",
                           elapsed=time.time() - t0)

    def shutdown(self, timeout: float = 60.0) -> None:
        """Stop the worker after the jobs already queued."""
        self.queue.put(None)
        self._worker.join(timeout)


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

