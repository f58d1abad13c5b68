"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its file: each cell's configuration and traffic mix, each
per-layer metric's reader, each entry point's count and the program
attribute it wraps."""

import importlib
import json
import os
import re

import pytest

from lsbench import counts
from lsbench.spec import HERE, ROOT, load_cell

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_run_length():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["lsbench"]
    assert BENCH["command"] == ["python3", "lsbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check with the 24 cells the contract allows fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(cell):
    c = load_cell(cell)
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                    if w["name"] == cell)
    assert c.traffic["name"] == next(w["traffic"] for w in BENCH["workloads"]
                                     if w["name"] == cell)
    assert c.chips == 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_names_units_and_bounds():
    seen = set()
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + \
            BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
        assert entry["name"] not in seen
        seen.add(entry["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for c in BENCH["configs"]:
        assert c["file"].startswith("lsbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == []


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    mod = counts.load_module(os.path.join(HERE, "metrics", metric + ".py"), "m_" + metric)
    assert callable(mod.read)
    for targets in getattr(mod, "RANGES", {}).values():
        for t in targets:
            module, attr = t.split(":")
            assert hasattr(importlib.import_module(module), attr), t


@pytest.mark.parametrize("entry", sorted(counts.entries()))
def test_every_entry_wraps_an_attribute_of_the_port(entry):
    mod = counts.entries()[entry]
    assert mod.TARGETS and callable(mod.count)
    for t in mod.TARGETS:
        module, attr = t.split(":")
        assert module.startswith("latentsync_tpu_torch.")
        assert callable(getattr(importlib.import_module(module), attr)), t


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_the_check_judges_the_longest_request_first(seed):
    from lsbench.check import choose

    config = {"check": {"requests": 2, "max_windows": 14}}
    windows = [3, 10, 2, 4, 10, 7]
    chosen = choose(list(range(len(windows))), lambda i: windows[i], config, seed)
    assert windows[chosen[0]] == 10
    assert len(chosen) == 2 and sum(windows[i] for i in chosen) <= 14
    # a longest request over the budget is judged all the same, alone
    assert choose([0, 1], lambda i: [3, 20][i], config, seed) == [1]


def test_a_fixed_clip_order_is_the_same_for_every_seed(tmp_path):
    from lsbench.inputs import clip_pool

    spec = {"dist": "uniform", "min_s": 0.2, "max_s": 0.5, "pool": 6, "order": "fixed"}
    for d in "abc":
        (tmp_path / d).mkdir()
    a = [s for s, _ in clip_pool(spec, 1, str(tmp_path / "a"))]
    b = [s for s, _ in clip_pool(spec, 2**31 + 9, str(tmp_path / "b"))]
    assert a == b and sorted(a) != a
    seeded = dict(spec, order="seeded")
    c = [s for s, _ in clip_pool(seeded, 1, str(tmp_path / "c"))]
    assert sorted(c) == sorted(a)


def test_the_denoise_readers_count_windows_from_the_traced_forwards():
    mdir = os.path.join(HERE, "metrics")
    den = counts.load_module(os.path.join(mdir, "denoise.device_ms_per_window.py"), "m_den")
    i8 = counts.load_module(os.path.join(mdir, "int8_conv.ms_per_window.py"), "m_i8")
    # 40 forwards of 8-window calls at 20 steps: 16 windows; 8 s and 4 s of device time
    run = {"config": {"inference_steps": 20},
           "trace": {"ranges": {"unet_forward": (40, 8.0, 320.0), "int8_conv": (900, 4.0, 0.0)}}}
    assert den.read(run) == pytest.approx(500.0)
    assert i8.read(run) == pytest.approx(250.0)
    assert den.read({"config": {"inference_steps": 20}, "trace": {"ranges": {}}}) is None
    assert i8.read({"config": {"inference_steps": 20}, "trace": {"ranges": {}}}) is None
