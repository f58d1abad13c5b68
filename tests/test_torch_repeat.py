"""The port's ``utils/repeat.py`` against the JAX package's, on the CPU.

All seven functions on the same numpy inputs made from a seed, as arrays and
as lists, with the length below, at and above the target or multiple: the
outputs must be equal (arrays bit for bit, ``padding_sec`` exactly).
``process_video_with_trim`` runs on the 40-frame clip of
``tests/test_face_and_utils.py``'s ``test_repeat_tail_helpers`` (a dark
16-frame lead-in, a bright body, 1.6 s of audio), each package on its own
copy, through each package's media layer: the decoded frames and the sidecar
audio must be equal, with trailing padding cut and without.
"""

import shutil

import numpy as np
import pytest

from latentsync_tpu.utils import media as jmedia
from latentsync_tpu.utils import repeat as jrepeat
from latentsync_tpu_torch.utils import media as pmedia
from latentsync_tpu_torch.utils import repeat as prepeat

from test_torch_ops import _one_torch_thread  # noqa: F401 (autouse)

SR = 16000


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


def _inputs(n, as_list, seed=0):
    rng = np.random.default_rng(seed)
    arr = rng.standard_normal((n, 3, 2)).astype(np.float32)
    return [a for a in arr] if as_list else arr


@pytest.mark.parametrize("as_list", [False, True], ids=["array", "list"])
@pytest.mark.parametrize("n", [3, 8, 13])
@pytest.mark.parametrize("name", ["repeat_to_length", "truncate_to_length",
                                  "duplicate_first_frames"])
def test_length_helpers_match_jax(name, n, as_list):
    """n below, at and above the target 8."""
    x = _inputs(n, as_list)
    _same(getattr(prepeat, name)(x, 8), getattr(jrepeat, name)(_inputs(n, as_list), 8))


@pytest.mark.parametrize("as_list", [False, True], ids=["array", "list"])
def test_duplicate_first_frames_of_an_empty_input(as_list):
    x = [] if as_list else np.zeros((0, 4, 4, 3), np.uint8)
    got, want = prepeat.duplicate_first_frames(x, 16), jrepeat.duplicate_first_frames(x, 16)
    assert got is x and want is x


def _chunks(n, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 50, 6)).astype(np.float32),
            (0.1 * rng.standard_normal(int(n / 25 * SR) + 37)).astype(np.float32))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 40])
@pytest.mark.parametrize("name", ["pad_chunks_end", "pad_chunks_start"])
def test_pad_chunks_match_jax(name, n):
    """n below, at and above a multiple of 16."""
    chunks, audio = _chunks(n)
    got = getattr(prepeat, name)(chunks, audio, SR, fps=25, multiple=16)
    want = getattr(jrepeat, name)(*_chunks(n), SR, fps=25, multiple=16)
    _same(got, want)
    assert len(got[0]) % 16 == 0


@pytest.mark.parametrize("n", [5, 20, 24, 31])
def test_pad_chunks_to_target_matches_jax(n):
    """Padded (n < 20), exact (n = 20) and the truncating branch (n > 20),
    where the audio loses the cut duration."""
    chunks, audio = _chunks(n)
    got = prepeat.pad_chunks_to_target(chunks, audio, SR, 20, fps=25)
    _same(got, jrepeat.pad_chunks_to_target(*_chunks(n), SR, 20, fps=25))
    assert len(got[0]) == 20
    if n > 20:
        assert got[2] == 0.0 and len(got[1]) < len(audio)


@pytest.mark.parametrize("seconds", [0, 0.5, 1])
def test_add_start_silence_matches_jax(seconds):
    audio = _chunks(10)[1]
    got = prepeat.add_start_silence(audio, SR, silence_duration=seconds)
    _same(got, jrepeat.add_start_silence(audio, SR, silence_duration=seconds))
    assert not got[:int(seconds * SR)].any()


@pytest.fixture(scope="module")
def trim_dir(tmp_path_factory):
    """``test_repeat_tail_helpers``' clip: 16 dark lead-in frames, 24 bright
    ones, 1.6 s of audio (written by the JAX package's media layer)."""
    import cv2

    temp = tmp_path_factory.mktemp("trim") / "temp"
    temp.mkdir()
    lead = np.zeros((16, 32, 32, 3), np.uint8)
    body = np.full((24, 32, 32, 3), 200, np.uint8)
    w = cv2.VideoWriter(str(temp / "video.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25, (32, 32))
    for fr in np.concatenate([lead, body]):
        w.write(fr)
    w.release()
    rng = np.random.default_rng(2)
    jmedia.write_audio(str(temp / "audio.wav"),
                       (0.1 * rng.standard_normal(int(40 / 25 * SR))).astype(np.float32))
    return temp


@pytest.mark.parametrize("padding,frames", [(8 / 25, 16), (0, 24)])
def test_process_video_with_trim_matches_jax(trim_dir, tmp_path, padding, frames):
    assert not pmedia.have_ffmpeg() and not jmedia.HAVE_FFMPEG  # both OpenCV branches
    outs = {}
    for name, mod in (("port", prepeat), ("jax", jrepeat)):
        temp = tmp_path / name / "temp"
        shutil.copytree(trim_dir, temp)
        out = mod.process_video_with_trim(str(temp), str(tmp_path / name / "out.mp4"),
                                          padding_duration=padding)
        assert out == str(tmp_path / name / "out.mp4")
        outs[name] = (jmedia.read_video(out, change_fps=False),
                      jmedia.read_audio(str(tmp_path / name / "out.wav"), SR))
    (p_frames, p_audio), (j_frames, j_audio) = outs["port"], outs["jax"]
    assert len(p_frames) == frames
    np.testing.assert_array_equal(p_frames, j_frames)
    assert p_frames.mean() > 150  # the lead-in is gone
    assert len(p_audio) == int(frames / 25 * SR)
    np.testing.assert_array_equal(p_audio, j_audio)
