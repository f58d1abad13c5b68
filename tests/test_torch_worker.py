"""The port's job-queue worker and its helpers.

Counterparts of ``tests/test_worker_helpers.py`` and the queue / worker
tests of ``tests/test_serving_eval.py``, held against the JAX package's
helpers where both compute the same thing (cue text, VTT, commands), plus
what only the port has: concatenation and trimming without an ffmpeg
binary, through the port's media layer (OpenCV frames, ``.wav`` sidecars),
and a worker draining three jobs (plain, dependent with ``concat_with``,
with subtitles) against the port's HTTP server.
"""

import base64
import json
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from latentsync_tpu.serving import helpers as jhelpers
from latentsync_tpu_torch.serving import helpers
from latentsync_tpu_torch.serving.api import ServingState, make_handler
from latentsync_tpu_torch.serving.artifacts import AvatarStore
from latentsync_tpu_torch.serving.worker import LocalDirQueue, QueueWorker
from latentsync_tpu_torch.utils import media

TEXTS = ["hello world", "This is the first sentence. And here comes a second sentence.",
         "word " * 30, "no punctuation but a rather long line that must wrap somewhere ok",
         "Question? Answer! Colon: semicolon; done"]


@pytest.mark.parametrize("text", TEXTS)
def test_format_cue_text_matches_jax(text):
    assert helpers.format_cue_text(text.strip()) == jhelpers.format_cue_text(text.strip())


def test_format_cue_text_wraps_long_lines_without_splitting_words():
    out = helpers.format_cue_text(("word " * 30).strip())
    for line in out.splitlines():
        assert len(line) <= 41 and all(w == "word" for w in line.split())


def test_segments_to_vtt_and_line_breaks_match_jax():
    segs = [{"start": 0.0, "end": 1.5, "text": "short cue"},
            {"start": 1.5, "end": 9.25, "text": "a much longer cue that should be wrapped. "
                                                "second part here to exceed width"},
            {"start": 3601.0049, "end": 3700.5, "text": " spaced "}]
    vtt = helpers.add_line_breaks_to_vtt(helpers.segments_to_vtt(segs))
    assert vtt == jhelpers.add_line_breaks_to_vtt(jhelpers.segments_to_vtt(segs))
    assert vtt.startswith("WEBVTT") and "00:00:01.500 --> 00:00:09.250" in vtt
    assert "\n" in vtt.split("00:00:01.500 --> 00:00:09.250")[1].strip()


def test_vtt_data_uri_roundtrip():
    uri = helpers.vtt_to_data_uri("WEBVTT\n\nhello")
    assert uri == jhelpers.vtt_to_data_uri("WEBVTT\n\nhello")
    assert base64.b64decode(uri.split(",", 1)[1]).decode() == "WEBVTT\n\nhello"


def test_generate_subtitles(tmp_path):
    def transcriber(path):
        assert path == "audio.wav"
        return [{"start": 0, "end": 2, "text": "hello there"}]

    uri = helpers.generate_subtitles("audio.wav", transcriber, output_dir=str(tmp_path))
    assert uri and uri.startswith("data:text/vtt;base64,")
    assert (tmp_path / "audio.vtt").exists()

    def bad(_):
        raise RuntimeError("asr down")

    assert helpers.generate_subtitles("x.wav", bad) is None


def test_last_word_end_and_commands_match_jax():
    data = {"segments": [{"words": [{"end": 1.0}, {"end": 2.5}]}, {"words": [{"end": 4.25}]}]}
    assert helpers.last_word_end(data) == jhelpers.last_word_end(data) == 4.25
    got, want = [], []
    assert helpers.trim_video_after_last_word("in.mp4", "out.mp4", data, run=got.append) == \
        jhelpers.trim_video_after_last_word("in.mp4", "out.mp4", data, run=want.append) == 4.75
    helpers.concat_videos(["a.mp4", "b.mp4", "c.mp4"], "out.mp4", run=got.append)
    jhelpers.concat_videos(["a.mp4", "b.mp4", "c.mp4"], "out.mp4", run=want.append)
    assert got == want and "concat=n=3:v=1:a=1" in got[1][got[1].index("-filter_complex") + 1]
    for bad in (["only.mp4"], ["a.mp4", ""]):
        with pytest.raises(ValueError):
            helpers.concat_videos(bad, "out.mp4", run=lambda c: None)


def test_row_logger(tmp_path):
    logger = helpers.RowLogger(spool_dir=str(tmp_path))
    assert logger.insert_rows("latentsync", "jobs", [{"job_id": "j1"}, {"job_id": "j2"}])[
        "success"]
    lines = (tmp_path / "latentsync.jobs.ndjson").read_text().splitlines()
    assert [json.loads(x)["job_id"] for x in lines] == ["j1", "j2"]

    def bad(*a):
        raise RuntimeError("no bq")

    r = helpers.RowLogger(transport=bad).insert_rows("d", "t", [{}])
    assert not r["success"] and "no bq" in r["error"]


def test_stop_vm_and_idle_shutdown(monkeypatch):
    monkeypatch.delenv("GCP_ZONE", raising=False)
    monkeypatch.delenv("GCP_INSTANCE_NAME", raising=False)
    assert helpers.stop_vm() is False
    cmds = []
    assert helpers.stop_vm(project_id="p", zone="z", instance_name="vm", run=cmds.append)
    assert cmds[0][:4] == ["gcloud", "compute", "instances", "stop"] and "--project" in cmds[0]
    fired = []
    idle = helpers.IdleShutdown(max_idle=3, stopper=lambda: fired.append(1) or True)
    for n in (2, 0, 0):
        idle.tick(n)
    assert not fired and idle.tick(0)
    idle.tick(0)
    assert fired == [1]


def _clip(path, n, hw=(48, 64), fps=25, seed=0, audio=True):
    """A clip written through the port's media layer (no ffmpeg: mp4v + a
    .wav sidecar); returns its frames and audio."""
    rng = np.random.default_rng(seed)
    frames = np.repeat(rng.integers(0, 256, (n, 1, 1, 3), dtype=np.uint8), hw[0], 1)
    frames = np.repeat(frames, hw[1], 2)
    samples = (0.2 * rng.standard_normal(int(16000 * n / fps))).astype(np.float32)
    wav = None
    if audio:
        wav = str(path) + ".in.wav"
        media.write_audio(wav, samples)
    writer = media.StreamingVideoWriter(str(path), fps=fps, frame_hw=hw, audio_path=wav)
    writer.append(frames)
    return writer.close(), frames, samples


@pytest.fixture
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(media, "have_ffmpeg", lambda: False)


def test_concat_without_ffmpeg(tmp_path, no_ffmpeg):
    a, fa, sa = _clip(tmp_path / "a.mp4", 10, seed=1)
    b, fb, sb = _clip(tmp_path / "b.mp4", 7, seed=2)
    out = helpers.concat_videos([a, b], str(tmp_path / "ab.mp4"))
    frames = media.read_video(out, change_fps=False)
    assert frames.shape == (17, 48, 64, 3)
    # flat colours survive the codec: each frame is its source's
    want = np.concatenate([fa, fb])[:, 24, 32].astype(int)
    assert np.abs(frames[:, 24, 32].astype(int) - want).max() <= 8
    audio = media.read_audio(str(tmp_path / "ab.wav"))
    assert len(audio) == len(sa) + len(sb)
    np.testing.assert_allclose(audio, np.concatenate([sa, sb]), atol=1 / 16384)
    c, _, _ = _clip(tmp_path / "c.mp4", 5, hw=(32, 32))
    with pytest.raises(ValueError, match="frame sizes"):
        helpers.concat_videos([a, c], str(tmp_path / "ac.mp4"))
    d, _, _ = _clip(tmp_path / "d.mp4", 5, audio=False)
    with pytest.raises(ValueError, match="audio"):
        helpers.concat_videos([a, d], str(tmp_path / "ad.mp4"))


@pytest.mark.parametrize("last_end,want_frames", [(0.1, 15), (0.16, 17), (2.0, 30)])
def test_trim_without_ffmpeg(tmp_path, no_ffmpeg, last_end, want_frames):
    """Frames before the cut (last word + 0.5 s) and the samples up to it."""
    src, frames, samples = _clip(tmp_path / "v.mp4", 30, seed=3)
    out = str(tmp_path / "t.mp4")
    data = {"segments": [{"words": [{"end": last_end}]}]}
    assert helpers.trim_video_after_last_word(src, out, data) == last_end + 0.5
    assert media.read_video(out, change_fps=False).shape[0] == want_frames
    audio = media.read_audio(str(tmp_path / "t.wav"))
    assert len(audio) == min(len(samples), int(round((last_end + 0.5) * 16000)))


def test_local_queue_roundtrip(tmp_path):
    q = LocalDirQueue(str(tmp_path))
    jid = q.submit({"avatar_id": "a", "audio_path": "x.wav"})
    assert q.get(jid)["status"] == "pending" and len(q.pending()) == 1
    q.update(jid, status="completed", output="out.mp4")
    assert q.pending() == [] and q.get(jid)["output"] == "out.mp4"
    assert q.get("missing") is None


def test_worker_dependency_gating(tmp_path):
    q = LocalDirQueue(str(tmp_path))
    dep = q.submit({"id": "a", "avatar_id": "a", "audio_path": "x.wav"})
    child = q.submit({"id": "b", "avatar_id": "b", "audio_path": "y.wav",
                      "status": "waiting-dependency", "dependencies": [dep]})
    rows = []
    logger = helpers.RowLogger(transport=lambda dataset, table, new: rows.extend(new))
    worker = QueueWorker(q, api_url="http://127.0.0.1:9", row_logger=logger)
    worker.handle_job(q.get(child))
    assert q.get(child)["status"] == "waiting-dependency"  # the dependency is not done
    q.update(dep, status="completed")
    worker.handle_job(q.get(child))  # the gate opens; the API is unreachable
    assert q.get(child)["status"] == "failed" and rows[-1]["status"] == "failed"


def test_worker_postprocess_concat_and_subs(tmp_path, monkeypatch):
    q = LocalDirQueue(str(tmp_path / "q"))
    q.submit({"id": "dep1", "status": "completed", "output": "dep1.mp4"})
    calls = []
    monkeypatch.setattr(helpers, "concat_videos",
                        lambda paths, out, run=None: calls.append(list(paths)) or out)
    worker = QueueWorker(queue=q, transcriber=lambda p: [{"start": 0, "end": 1, "text": "hi"}])
    extra = worker._postprocess({"id": "j", "concat_with": ["dep1"], "subtitles": True,
                                 "audio_path": "a.wav"}, "j.mp4")
    assert calls == [["dep1.mp4", "j.mp4"]]
    assert extra["output"].endswith("_concat.mp4") and extra["concatenated"]
    assert extra["subtitles_uri"].startswith("data:text/vtt")
    with pytest.raises(RuntimeError, match="no output"):
        worker._postprocess({"id": "k", "concat_with": ["missing"]}, "k.mp4")


def test_default_transcriber_needs_both_assets(tmp_path, monkeypatch, capsys):
    from latentsync_tpu_torch.serving import worker as pworker

    monkeypatch.delenv("LATENTSYNC_WHISPER_CKPT", raising=False)
    monkeypatch.delenv("LATENTSYNC_WHISPER_VOCAB", raising=False)
    assert pworker._default_transcriber() is None
    monkeypatch.setenv("LATENTSYNC_WHISPER_VOCAB", str(tmp_path))
    assert pworker._default_transcriber() is None
    assert "need BOTH" in capsys.readouterr().out


class _ClipPipeline:
    """Stands in for LipsyncPipeline behind the server: writes a real clip
    (frames = 10 a second of audio) through the port's media layer."""

    def __call__(self, video_path, audio_path, video_out_path, **kw):
        from dataclasses import dataclass

        samples = media.read_audio(audio_path)
        n = max(1, int(round(len(samples) / 1600)))
        path, _, _ = _clip(video_out_path, n, fps=10, seed=n)

        @dataclass
        class Out:
            video_path: str
            num_frames: int
            elapsed: dict

        return Out(path, n, {"total": 0.0})


def test_worker_drains_three_jobs_against_the_server(tmp_path, no_ffmpeg):
    """A plain job, one waiting on it that is concatenated after its output,
    and one with subtitles: all complete; the concatenation has the sum of
    the frames; the subtitles come back as a data URI."""
    avatars = tmp_path / "avatars"
    avatars.mkdir()
    (avatars / "alice.mp4").write_text("unused")
    audios = {}
    for name, sec in (("a", 0.8), ("b", 1.2), ("c", 0.5)):
        audios[name] = str(tmp_path / f"{name}.wav")
        media.write_audio(audios[name], np.zeros(int(16000 * sec), np.float32))
    state = ServingState(_ClipPipeline(), AvatarStore(str(avatars)), str(tmp_path / "out"))
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        q = LocalDirQueue(str(tmp_path / "queue"))
        q.submit({"id": "j1", "avatar_id": "alice", "audio_path": audios["a"]})
        q.submit({"id": "j2", "avatar_id": "alice", "audio_path": audios["b"],
                  "status": "waiting-dependency", "dependencies": ["j1"], "concat_with": ["j1"]})
        q.submit({"id": "j3", "avatar_id": "alice", "audio_path": audios["c"],
                  "subtitles": True})
        seen = []
        worker = QueueWorker(q, api_url=f"http://127.0.0.1:{server.server_address[1]}",
                             status_listeners=[lambda j: seen.append((j["id"], j["status"]))],
                             transcriber=lambda p: [{"start": 0.0, "end": 0.4, "text": "hi"}])
        assert worker.run_once() == 3
    finally:
        server.shutdown()
        server.server_close()
        state.shutdown()
    jobs = {j: q.get(j) for j in ("j1", "j2", "j3")}
    assert {j: job["status"] for j, job in jobs.items()} == dict.fromkeys(jobs, "completed")
    n = [media.read_video(jobs[j]["output"], change_fps=False).shape[0] for j in jobs]
    assert n == [8, 8 + 12, 5] and jobs["j2"]["concatenated"]
    assert jobs["j3"]["subtitles_uri"].startswith("data:text/vtt;base64,")
    assert ("j2", "running") in seen and ("j3", "completed") in seen
