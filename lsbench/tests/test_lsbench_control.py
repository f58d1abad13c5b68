"""The control and the faults ``correct`` must catch.

The control (the reference one precision below the configuration's, in
the program's place) comes out as not correct; so does a run whose timed
path is broken underneath: a DDIM step that returns its state unchanged,
the second half of each denoise batch left out (its rows copies of the
first half's), an answer altered where it is produced (one window's
latents, or the audio chunks of a request). The ``cuda`` case runs the
control at each cell's own size on three seeds."""

import pytest

from lsbench.control import control
from lsbench.tests.conftest import BENCH, DATA


@pytest.mark.parametrize("workload", ["tiny.exact", "tiny.prod"])
def test_control_is_not_correct(workload):
    r = control(workload, 31337, "cpu", BENCH, DATA)
    assert not r["correct"], r["checks"]
    assert r["checks"]["latents_rel_l2"]["value"] > r["checks"]["latents_rel_l2"]["limit"]


def _ddim_unchanged(monkeypatch):
    from latentsync_tpu_torch.ops import ddim

    monkeypatch.setattr(ddim.DDIMScheduler, "step",
                        staticmethod(lambda eps, sample, a_t, a_p: sample))
    return None


def _half_batch(monkeypatch):
    def faults(pipe):
        orig = pipe._denoise

        def half(*a, **k):
            out = orig(*a, **k)
            h = max(1, out.shape[0] // 2)
            out = out.clone()
            out[h:] = out[:h][: out.shape[0] - h]
            return out

        pipe._denoise = half
    return faults


def _window_altered(monkeypatch):
    def faults(pipe):
        orig = pipe._denoise

        def altered(*a, **k):
            out = orig(*a, **k).clone()
            out[0] = out[0] * 1.05
            return out

        pipe._denoise = altered
    return faults


def _audio_altered(monkeypatch):
    def faults(pipe):
        orig = pipe.prepare

        def altered(*a, **k):
            state = orig(*a, **k)
            state.audio_w = state.audio_w * 1.01
            return state

        pipe.prepare = altered
    return faults


@pytest.mark.parametrize("fault", [_ddim_unchanged, _half_batch, _window_altered,
                                   _audio_altered])
def test_a_broken_timed_path_is_not_correct(tiny_run, monkeypatch, fault):
    faults = fault(monkeypatch)
    r = tiny_run("tiny.exact", 2024, faults=faults)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["prod.interactive", "exact.backlog"])
def test_control_at_the_cell_size_is_not_correct(cuda_device, workload):
    for seed in (1618033988, 2718281828, 1414213562):
        r = control(workload, seed, cuda_device)
        assert not r["correct"], r
