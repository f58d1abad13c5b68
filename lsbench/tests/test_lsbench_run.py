"""A tiny cell end to end on the CPU through the port's ``ServingState``
(the kernels' plain versions): the result line has the contract's keys,
the plain reference agrees with what the timed path served, and the
per-layer readers find what they read in a traced run."""

import json
import math

import pytest

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", ["tiny.exact", "tiny.prod"])
def test_tiny_cell_runs_and_the_reference_agrees(tiny_run, workload):
    r = tiny_run(workload, 2**31 + 12345, seconds=4.0)
    assert [k for k in r if k in CONTRACT] == CONTRACT
    assert list(r)[-1] == "checks"
    json.dumps(r)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    m = r["metrics"]
    assert set(m) == {"frames_per_s", "latency_p50_s", "latency_p90_s", "setup_s"}
    assert all(v["value"] > 0 for v in m.values())
    assert r["device"]["platform"] == "cpu"
    for name, row in r["checks"].items():
        assert math.isfinite(row["value"]) and row["value"] <= row["limit"], name


def test_traced_tiny_cell_reports_its_host_layers(tiny_run):
    r = tiny_run("tiny.prod", 424242, seconds=2.0, trace=True)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    # the device readers find nothing on the CPU and leave their metric out
    assert {"batcher.fill", "prepare.ms_per_request", "finish.ms_per_frame"} <= set(m)
    assert not {"mfu", "kernels.roofline", "device.idle_share",
                "denoise.device_ms_per_window"} & set(m)
    assert 0 < m["batcher.fill"]["value"] <= 100
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "window_s" in r["device"] and "busy_s" in r["device"]


def test_a_perturbed_output_fails_the_comparison(tiny_run):
    """The served frames with the pasted faces shifted by a few codes."""
    from latentsync_tpu_torch.pipelines import lipsync

    def faults(pipe):
        orig = lipsync.restore_frames_device

        def shifted(frames, faces, *a, **k):
            return orig(frames, (faces.astype("int16") + 6).clip(0, 255).astype("uint8"),
                        *a, **k)

        lipsync.restore_frames_device = shifted
        faults.undo = lambda: setattr(lipsync, "restore_frames_device", orig)

    try:
        r = tiny_run("tiny.exact", 77, faults=faults)
    finally:
        faults.undo()
    assert not r["correct"]
    assert r["checks"]["frames_rms"]["value"] > r["checks"]["frames_rms"]["limit"]
