"""Job-queue worker: polls a queue, drives the HTTP API, fans out status.

Counterpart of ``latentsync_tpu/serving/worker.py``: a poll loop over a
pluggable queue backend (a directory of JSON files by default),
dependency-gated jobs (``waiting-dependency`` until every job in
``dependencies`` has completed), an optional TTS hook, a POST to the
port's inference server (``serving/api.py``: ``/process``, then
``/jobs/<id>`` until the job ends), the dynamic-clip tail (concatenation
after the outputs of ``concat_with``, subtitles from the in-repo
transcriber), an upload hook, and a pending → running → completed /
failed status machine in which the status field is the job's lock.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class LocalDirQueue:
    """Filesystem queue backend: one JSON file a job under `root`."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, job_id: str) -> str:
        return os.path.join(self.root, f"{job_id}.json")

    def submit(self, job: Dict) -> str:
        job_id = job.get("id") or f"job-{int(time.time() * 1000)}"
        job = {**job, "id": job_id, "status": job.get("status", "pending")}
        with open(self._path(job_id), "w") as f:
            json.dump(job, f)
        return job_id

    def pending(self) -> List[Dict]:
        jobs = []
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".json"):
                continue
            with open(os.path.join(self.root, name)) as f:
                job = json.load(f)
            if job.get("status") in ("pending", "waiting-dependency"):
                jobs.append(job)
        return jobs

    def get(self, job_id: str) -> Optional[Dict]:
        p = self._path(job_id)
        if not os.path.isfile(p):
            return None
        with open(p) as f:
            return json.load(f)

    def update(self, job_id: str, **fields) -> None:
        job = self.get(job_id) or {"id": job_id}
        job.update(fields)
        with open(self._path(job_id), "w") as f:
            json.dump(job, f)


def _default_transcriber():
    """The in-repo transcriber when both ``$LATENTSYNC_WHISPER_VOCAB`` and
    ``$LATENTSYNC_WHISPER_CKPT`` are set (with the vocab alone the models
    would have random weights and the subtitles would be gibberish); None
    otherwise, or when it cannot be made."""
    vocab = os.environ.get("LATENTSYNC_WHISPER_VOCAB")
    ckpt = os.environ.get("LATENTSYNC_WHISPER_CKPT")
    if not vocab or not ckpt or not os.path.isfile(ckpt):
        if vocab or ckpt:
            print("in-repo transcriber unconfigured: need BOTH LATENTSYNC_WHISPER_VOCAB and "
                  f"LATENTSYNC_WHISPER_CKPT (vocab={vocab!r}, ckpt={ckpt!r}): subtitles disabled")
        return None
    try:
        from ..audio.transcribe import make_transcriber

        return make_transcriber()
    except Exception as e:  # noqa: BLE001 — subtitles are best-effort
        print(f"in-repo transcriber unavailable: {e}")
        return None


@dataclass
class QueueWorker:
    queue: LocalDirQueue
    api_url: str = "http://localhost:8000"
    poll_interval: float = 5.0
    tts_fn: Optional[Callable[[Dict], str]] = None          # job → audio path
    upload_fn: Optional[Callable[[str, Dict], str]] = None  # path → url
    status_listeners: List[Callable[[Dict], None]] = field(default_factory=list)
    transcriber: Optional[Callable[[str], List[Dict]]] = None  # audio → segments
    row_logger: Optional[object] = None      # helpers.RowLogger
    idle_shutdown: Optional[object] = None   # helpers.IdleShutdown

    def _postprocess(self, job: Dict, output: str) -> Dict:
        """The dynamic-clip tail: concatenate this clip after its
        dependencies' outputs, then make subtitles for the result."""
        from . import helpers

        extra: Dict = {}
        concat_ids = job.get("concat_with") or []
        if concat_ids:
            parts = []
            for dep_id in concat_ids:
                dep = self.queue.get(dep_id)
                if not dep or not dep.get("output"):
                    raise RuntimeError(f"concat dependency {dep_id} has no output")
                parts.append(dep["output"])
            parts.append(output)
            merged = os.path.splitext(output)[0] + "_concat.mp4"
            helpers.concat_videos(parts, merged)
            output = merged
            extra["concatenated"] = True
        if job.get("subtitles"):
            if self.transcriber is None:
                self.transcriber = _default_transcriber()
            if self.transcriber is not None:
                uri = helpers.generate_subtitles(job.get("audio_path") or output,
                                                 self.transcriber)
                if uri:
                    extra["subtitles_uri"] = uri
        extra["output"] = output
        return extra

    def _notify(self, job: Dict) -> None:
        for listener in self.status_listeners:
            listener(job)

    def _dependencies_done(self, job: Dict) -> bool:
        for dep in job.get("dependencies", []):
            dep_job = self.queue.get(dep)
            if dep_job is None or dep_job.get("status") != "completed":
                return False
        return True

    def _log_row(self, row: Dict) -> None:
        if self.row_logger is not None:
            self.row_logger.insert_rows("latentsync", "jobs", [row])

    def handle_job(self, job: Dict) -> None:
        job_id = job["id"]
        if job.get("status") == "waiting-dependency":
            if not self._dependencies_done(job):
                return
            self.queue.update(job_id, status="pending")
            job["status"] = "pending"

        job["started"] = time.time()
        self.queue.update(job_id, status="running", started=job["started"])
        self._notify({**job, "status": "running"})
        try:
            audio_path = job.get("audio_path")
            if not audio_path and self.tts_fn is not None:
                audio_path = self.tts_fn(job)
            payload = json.dumps({
                "avatar_id": job["avatar_id"], "audio_path": audio_path, "job_id": job_id,
                **{k: job[k] for k in ("inference_steps", "guidance_scale", "rotated", "darken")
                   if k in job},
            }).encode()
            req = urllib.request.Request(f"{self.api_url}/process", data=payload,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                submitted = json.loads(resp.read())
            while True:
                with urllib.request.urlopen(f"{self.api_url}/jobs/{submitted['job_id']}",
                                            timeout=30) as resp:
                    api_job = json.loads(resp.read())
                if api_job["status"] in ("completed", "failed"):
                    break
                time.sleep(1.0)
            if api_job["status"] != "completed":
                raise RuntimeError(api_job.get("error", "inference failed"))
            extra = self._postprocess(job, api_job["output"])
            output = extra.pop("output")
            url = self.upload_fn(output, job) if self.upload_fn else output
            self.queue.update(job_id, status="completed", output=url, finished=time.time(),
                              **extra)
            self._notify({**job, "status": "completed", "output": url, **extra})
            self._log_row({"job_id": job_id, "status": "completed", "output": url,
                           "elapsed": time.time() - job.get("started", time.time())})
        except Exception as e:  # noqa: BLE001 — one job's failure does not stop the worker
            self.queue.update(job_id, status="failed", error=str(e))
            self._notify({**job, "status": "failed", "error": str(e)})
            self._log_row({"job_id": job_id, "status": "failed", "error": str(e)})

    def run_once(self) -> int:
        jobs = self.queue.pending()
        for job in jobs:
            self.handle_job(job)
        return len(jobs)

    def run_forever(self):
        while True:
            n = self.run_once()
            if self.idle_shutdown is not None:
                self.idle_shutdown.tick(n)
            time.sleep(self.poll_interval)


def gcs_upload_fn(bucket: str, prefix: str = "") -> Callable[[str, Dict], str]:
    """The GCS upload hook, for where google-cloud-storage is installed."""
    def upload(path: str, job: Dict) -> str:
        try:
            from google.cloud import storage  # type: ignore
        except ImportError as e:
            raise RuntimeError("google-cloud-storage not installed") from e
        blob_name = os.path.join(prefix, os.path.basename(path))
        storage.Client().bucket(bucket).blob(blob_name).upload_from_filename(path)
        return f"https://storage.googleapis.com/{bucket}/{blob_name}"

    return upload
