"""Serving-side job helpers: subtitles, video concat and trim, metrics rows,
VM control.

Counterpart of ``latentsync_tpu/serving/helpers.py``. Every external
service (the ASR model, BigQuery, GCE) is a pluggable callable with a
local default. ``concat_videos`` and ``trim_video_after_last_word`` run the
reference's ffmpeg command when an ffmpeg binary exists (or a `run` is
given); without one they go through the port's own media layer, as every
other video write of the port does: frames through OpenCV, audio through
the ``.wav`` sidecar beside each video, frames and samples joined or cut
alike.
"""

from __future__ import annotations

import base64
import json
import math
import os
import subprocess
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


# ---------------------------------------------------------------------------
# subtitles
# ---------------------------------------------------------------------------


def format_cue_text(text: str, width: int = 40) -> str:
    """Split long cue text into readable lines: short text passes through;
    text with sentence punctuation breaks there; otherwise word-wrap at
    about `width` characters without splitting words."""
    text = text.strip()
    if len(text) < width:
        return text
    for bp in (". ", "! ", "? ", ": ", "; "):
        if bp in text:
            return (bp.rstrip() + "\n").join(part.strip() for part in text.split(bp))
    lines: List[str] = [""]
    for word in text.split(" "):
        if lines[-1] and len(lines[-1]) + 1 + len(word) > width:
            lines.append(word)
        else:
            lines[-1] = (lines[-1] + " " + word).strip()
    return "\n".join(lines)


def add_line_breaks_to_vtt(vtt_content: str) -> str:
    """Re-wrap every cue's text: the text lines between a ``-->`` line and
    the blank line that ends the cue are replaced by their wrapped form."""
    out: List[str] = []
    cue_text = ""
    in_cue = False
    for line in vtt_content.split("\n"):
        if "-->" in line:
            in_cue = True
            out.append(line)
            continue
        if in_cue and line.strip() == "":
            in_cue = False
            if cue_text:
                out.append(format_cue_text(cue_text))
                cue_text = ""
            out.append("")
            continue
        if in_cue:
            cue_text += line + " "
            continue
        out.append(line)
    if cue_text:
        out.append(format_cue_text(cue_text))
    return "\n".join(out)


def _vtt_ts(seconds: float) -> str:
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}.{ms:03d}"


def segments_to_vtt(segments: Sequence[Dict]) -> str:
    """[{start, end, text}] → a WEBVTT document."""
    lines = ["WEBVTT", ""]
    for seg in segments:
        lines.append(f"{_vtt_ts(float(seg['start']))} --> {_vtt_ts(float(seg['end']))}")
        lines.append(str(seg["text"]).strip())
        lines.append("")
    return "\n".join(lines)


def vtt_to_data_uri(vtt_content: str) -> str:
    """A base64 data URI, for embedding the subtitles directly."""
    b64 = base64.b64encode(vtt_content.encode("utf-8")).decode("ascii")
    return f"data:text/vtt;base64,{b64}"


def generate_subtitles(audio_path: str, transcriber: Callable[[str], List[Dict]],
                       output_dir: Optional[str] = None) -> Optional[str]:
    """Audio file → VTT data URI. `transcriber(audio_path)` returns [{start,
    end, text}] segments (``audio/transcribe.py``, or a stub). Returns None
    on any failure, as the reference does: subtitles are best-effort."""
    try:
        segments = transcriber(audio_path)
        vtt = add_line_breaks_to_vtt(segments_to_vtt(segments))
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            base = os.path.splitext(os.path.basename(audio_path))[0]
            with open(os.path.join(output_dir, base + ".vtt"), "w") as f:
                f.write(vtt)
        return vtt_to_data_uri(vtt)
    except Exception as e:  # noqa: BLE001 — the reference returns undefined here
        print(f"generate_subtitles failed: {e}")
        return None


def last_word_end(whisper_data: Dict) -> float:
    """The latest word-level end time of a transcript."""
    end = 0.0
    for segment in whisper_data.get("segments", []):
        for word in segment.get("words", []):
            end = max(end, float(word.get("end", 0.0)))
    return end


# ---------------------------------------------------------------------------
# video concat and trim
# ---------------------------------------------------------------------------


def _run_checked(cmd: List[str]) -> None:
    subprocess.run(cmd, check=True, capture_output=True)


def _use_ffmpeg(run) -> bool:
    from ..utils.media import have_ffmpeg

    return run is not None or have_ffmpeg()


def _sidecar(path: str) -> str:
    return os.path.splitext(path)[0] + ".wav"


def _read_clip(path: str):
    """(frames (N, H, W, 3) uint8, fps, audio samples or None) of a video the
    port's media layer wrote: OpenCV frames, the ``.wav`` sidecar's audio."""
    import cv2

    from ..utils.media import read_audio, read_video

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    if not fps > 0:
        raise IOError(f"cannot read the frame rate of {path}")
    frames = read_video(path, change_fps=False)
    audio = read_audio(_sidecar(path)) if os.path.isfile(_sidecar(path)) else None
    return frames, fps, audio


def _write_clip(path: str, frames, fps: float, audio) -> str:
    from ..utils.media import StreamingVideoWriter, write_audio

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(path))) as tmp:
        wav = None
        if audio is not None:
            wav = os.path.join(tmp, "audio.wav")
            write_audio(wav, audio)
        writer = StreamingVideoWriter(path, fps=fps, frame_hw=frames.shape[1:3], audio_path=wav)
        try:
            writer.append(frames)
            return writer.close()
        except BaseException:
            writer.abort()
            raise


def trim_video_after_last_word(video_path: str, trimmed_video_path: str, whisper_data: Dict,
                               buffer_sec: float = 0.5,
                               run: Callable[[List[str]], None] = None) -> float:
    """Cut the video `buffer_sec` after the last spoken word. Returns the
    cut point. Without ffmpeg: the frames whose time is before it, and the
    sidecar's samples up to it."""
    trim_end = last_word_end(whisper_data) + buffer_sec
    if _use_ffmpeg(run):
        cmd = ["ffmpeg", "-y", "-loglevel", "error", "-ss", "0", "-i", video_path,
               "-t", f"{trim_end:.3f}", trimmed_video_path]
        (run or _run_checked)(cmd)
        return trim_end
    frames, fps, audio = _read_clip(video_path)
    keep = min(len(frames), max(1, math.ceil(trim_end * fps - 1e-9)))
    if audio is not None:
        audio = audio[:int(round(trim_end * 16000))]
    _write_clip(trimmed_video_path, frames[:keep], fps, audio)
    return trim_end


def concat_videos(video_paths: Sequence[str], output_path: str,
                  run: Callable[[List[str]], None] = None) -> str:
    """Concatenate clips into one file: ffmpeg's re-encoding concat filter
    (video and audio streams), or without ffmpeg the frames and the
    sidecars' samples one after another at the first clip's frame rate.
    Clips must share a frame size, and either all or none carry audio."""
    if len(video_paths) < 2 or any(not p for p in video_paths):
        raise ValueError(f"need ≥2 valid inputs, got {video_paths!r}")
    if _use_ffmpeg(run):
        n = len(video_paths)
        inputs: List[str] = []
        for p in video_paths:
            inputs += ["-i", p]
        fc = "".join(f"[{i}:v:0][{i}:a:0]" for i in range(n))
        fc += f"concat=n={n}:v=1:a=1[outv][outa]"
        cmd = (["ffmpeg", "-y", "-loglevel", "error"] + inputs
               + ["-filter_complex", fc, "-map", "[outv]", "-map", "[outa]", output_path])
        (run or _run_checked)(cmd)
        return output_path
    import numpy as np

    clips = [_read_clip(p) for p in video_paths]
    if len({c[0].shape[1:] for c in clips}) != 1:
        raise ValueError(f"concat_videos: frame sizes differ: {[c[0].shape for c in clips]}")
    with_audio = [c[2] is not None for c in clips]
    if any(with_audio) and not all(with_audio):
        raise ValueError(f"concat_videos: some clips have no audio sidecar: {video_paths!r}")
    frames = np.concatenate([c[0] for c in clips])
    audio = np.concatenate([c[2] for c in clips]) if all(with_audio) else None
    _write_clip(output_path, frames, clips[0][1], audio)
    return output_path


# ---------------------------------------------------------------------------
# metrics rows
# ---------------------------------------------------------------------------


@dataclass
class RowLogger:
    """`insert_rows(dataset, table, rows)` with the BigQuery client as a
    pluggable transport. The default spools NDJSON to disk (one file a
    dataset.table, under the temporary directory unless `spool_dir` says
    otherwise); inject `transport=` to send to a real warehouse."""

    spool_dir: str = field(default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                                                "latentsync_rows"))
    transport: Optional[Callable[[str, str, List[Dict]], None]] = None
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def insert_rows(self, dataset_id: str, table_id: str, rows: List[Dict]) -> Dict:
        try:
            if self.transport is not None:
                self.transport(dataset_id, table_id, rows)
            else:
                os.makedirs(self.spool_dir, exist_ok=True)
                path = os.path.join(self.spool_dir, f"{dataset_id}.{table_id}.ndjson")
                with self._lock, open(path, "a") as f:
                    for row in rows:
                        f.write(json.dumps(row) + "\n")
            return {"success": True}
        except Exception as e:  # noqa: BLE001 — reported in the result, as the reference does
            print(f"Error inserting rows: {e}")
            return {"success": False, "error": str(e)}


def bigquery_transport(project_id: str) -> Callable[[str, str, List[Dict]], None]:
    """The BigQuery transport, for where google-cloud-bigquery is installed."""

    def send(dataset_id: str, table_id: str, rows: List[Dict]) -> None:
        from google.cloud import bigquery  # type: ignore

        client = bigquery.Client(project=project_id)
        errors = client.insert_rows_json(client.dataset(dataset_id).table(table_id), rows)
        if errors:
            raise RuntimeError(str(errors))

    return send


# ---------------------------------------------------------------------------
# instance control
# ---------------------------------------------------------------------------


def stop_vm(project_id: Optional[str] = None, zone: Optional[str] = None,
            instance_name: Optional[str] = None,
            run: Callable[[List[str]], None] = None) -> bool:
    """Stop this worker's VM when the queue drains, through the gcloud CLI;
    without a zone and an instance name it does nothing."""
    zone = zone or os.environ.get("GCP_ZONE")
    instance_name = instance_name or os.environ.get("GCP_INSTANCE_NAME")
    project_id = project_id or os.environ.get("GCP_PROJECT_ID")
    if not zone or not instance_name:
        print("stop_vm: environment variables missing: "
              + ("GCP_ZONE " if not zone else "")
              + ("GCP_INSTANCE_NAME" if not instance_name else ""))
        return False
    cmd = ["gcloud", "compute", "instances", "stop", instance_name, "--zone", zone]
    if project_id:
        cmd += ["--project", project_id]
    try:
        (run or _run_checked)(cmd)
        return True
    except Exception as e:  # noqa: BLE001 — reported, as the reference does
        print(f"stop_vm failed: {e}")
        return False


@dataclass
class IdleShutdown:
    """Poll-loop hook: call `tick(n_jobs)` each cycle; after `max_idle`
    consecutive empty polls, call the stopper once."""

    max_idle: int = 60
    stopper: Callable[[], bool] = stop_vm
    idle_count: int = 0
    fired: bool = False

    def tick(self, n_jobs: int) -> bool:
        if n_jobs > 0:
            self.idle_count = 0
            return False
        self.idle_count += 1
        if self.idle_count >= self.max_idle and not self.fired:
            self.fired = True
            self.stopper()
            return True
        return False
