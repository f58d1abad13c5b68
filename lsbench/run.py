"""Run one cell of the benchmark of ``latentsync_tpu_torch`` once.

    python3 lsbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m lsbench.run`` with the same arguments), from the root of a
checkout, on a machine with the cards the cell asks for. It builds the
port's serving stack in process (``ServingState`` over ``LipsyncPipeline``)
from the cell's configuration file with weights drawn on the card from the
seed, makes the cell's inputs from the seed (a synthetic avatar video with
its bundle and stored latents, a pool of speech clips), lets the traffic
mix's closed-loop clients run until as many requests as there are
clients are served (set-up ends there), measures from the end of the first
denoise call after that for ``--seconds`` (to the end of the first denoise
call at or after that time, so that the window holds whole batch cycles),
stops the clients, lets the requests in flight finish, frees the program,
has the plain reference judge a sample of the requests submitted in the
window, the longest among them, and prints one JSON line: the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``: ``torch.profiler`` over the last seconds of the window),
``correct`` with the numbers compared beside their limits, and the device.

It exits 2 without a result where there is no CUDA device or fewer than
the cell needs, and 3 where ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``latentsync_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the kernel caches live at fixed paths inside the checkout; the port builds
# its own kernels into latentsync_tpu_torch/_build/ and native/
CACHE = os.path.join(ROOT, ".lsbench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(CACHE, _sub)
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "latentsync_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``latentsync_tpu_torch`` is not ``latentsync_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"lsbench: {msg}", file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def _readers():
    from lsbench.counts import load_module

    out = {}
    mdir = os.path.join(HERE, "metrics")
    for fn in sorted(os.listdir(mdir)):
        if fn.endswith(".py") and not fn.startswith("_"):
            name = fn[:-3]
            out[name] = load_module(os.path.join(mdir, fn), "lsbench_metric_" + name.replace(".", "_"))
    return out


def _percentile(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        bench_path: str = None, traffic_dir: str = None, faults=None) -> dict:
    """One run of a cell; returns the result line as a dict (its "checks"
    last). `faults` (tests only) is called with the pipeline before the
    clients start, to break the timed path."""
    import numpy as np
    import torch

    from lsbench import check
    from lsbench.drive import Clients, Recorder, Spies
    from lsbench.inputs import clip_pool, write_avatar
    from lsbench.program import apply_switches, build_pipeline
    from lsbench.spec import load_cell
    from lsbench.tracing import TRACE_SECONDS, Tracer
    from lsbench.weights import signature

    cell = load_cell(workload, bench_path, traffic_dir)
    config, traffic = cell.config, cell.traffic
    device = torch.device(device)
    cuda = device.type == "cuda"
    apply_switches(config)
    steps, guidance = config["inference_steps"], config["guidance_scale"]
    serving = traffic["serving"]
    readers = _readers() if trace else {}
    ranges = {}
    for m in cell.per_layer if trace else ():
        ranges.update(getattr(readers[m["name"]], "RANGES", {}))

    work = tempfile.mkdtemp(prefix="lsbench-", dir=tempfile.gettempdir())
    try:
        if cuda:
            from latentsync_tpu_torch.ops import _build

            _build.build()
            _build.lib()
        from latentsync_tpu_torch.serving.api import ServingState
        from latentsync_tpu_torch.serving.artifacts import AvatarStore

        pipe, _ = build_pipeline(config, seed, device)
        sigs = {"unet": signature(pipe.unet), "vae": signature(pipe.vae),
                "whisper": signature(pipe.audio_encoder.model)}
        av = traffic["avatar"]
        res = config["data"]["resolution"]
        avatar = write_avatar(av, seed, work, res, device)
        pipe.precompute_avatar_latents(avatar["bundle"])
        os.makedirs(os.path.join(work, "clips"))
        pool = clip_pool(traffic["clips"], seed, os.path.join(work, "clips"))
        region = check.crop_region(avatar["boxes"], (av["height"], av["width"]))
        rec = Recorder(region)
        tracer = Tracer(ranges) if trace else None
        spies = Spies(pipe, rec, tracer)
        lat = res // 2 ** (len(config["vae"]["block_out_channels"]) - 1)
        f = config["data"]["num_frames"]
        for k in range(1, 64 // f + 1):  # finish decodes in chunks of 64 frames
            pipe._decode_u8(torch.zeros((k * f, lat, lat, 4), device=device))
        if faults is not None:
            faults(pipe)
        state = ServingState(pipe, AvatarStore(work), os.path.join(work, "out"),
                             max_queue=traffic["clients"] + 4,
                             continuous_batching=serving["continuous_batching"],
                             batch_windows=serving["batch_windows"],
                             num_workers=serving["workers"])
        if serving["continuous_batching"]:
            spies.watch_batcher(state._get_batcher(steps, guidance))
        if tracer:
            tracer.prepare()
        clients = Clients(state, rec, pool, traffic["clients"], steps, guidance)
        clients.start()
        for _ in range(traffic["clients"]):
            if not clients.completed.acquire(timeout=900):
                raise RuntimeError("warm-up: no request completed in 900 s")
        rec.capturing.set()
        t_warm = time.perf_counter()
        setup_s = t_warm - T_PROCESS
        t0 = rec.wait_batch_end(t_warm, timeout=900)
        if t0 is None:
            raise RuntimeError("no denoise call ended after warm-up")
        if tracer:  # the last TRACE_SECONDS before the window's length
            tracer.arm(t0 + max(0.0, seconds - TRACE_SECONDS), t0 + seconds)
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        if tracer and not tracer.done.wait(900):
            raise RuntimeError("no UNet forward ran after the window's length to stop the trace")
        t1 = rec.wait_batch_end(t0 + seconds, timeout=900)
        if t1 is None:
            raise RuntimeError("no denoise call ended after the window's length")
        clients.stop.set()
        drained = clients.join(900)
        state.shutdown(300)
        if cuda:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        window = t1 - t0
        reqs = list(clients.requests)
        # every request submitted after warm-up and before the window closed,
        # those still in flight then with the time they completed after it
        measured = [r for r in reqs if t_warm <= r.submitted <= t1]
        bad = {r.job_id for r in reqs if r.status != "completed"}
        frames = sum(n for t, job, n in rec.appends if t0 < t <= t1 and job not in bad)
        completed = [r for r in reqs if r.status == "completed" and t0 < r.done <= t1]
        lat_s = [r.done - r.submitted for r in measured if r.status == "completed"]
        e2e = {"frames_per_s": (frames / window, "frames/s"), "setup_s": (setup_s, "s")}
        if lat_s:
            e2e["latency_p50_s"] = (_percentile(lat_s, 50), "s")
            e2e["latency_p90_s"] = (_percentile(lat_s, 90), "s")
        metrics = {}
        if not trace:
            for m in cell.end_to_end:
                if m["name"] in e2e:
                    metrics[m["name"]] = {"value": e2e[m["name"]][0], "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
               "count": 1, "memory_peak_bytes": int(peak)}
        if cuda:
            dev["power_limit"] = power_limit()
        breakdown = None
        if trace:
            from lsbench.counts import peaks

            stages = [("prepare", a, b) for a, b in rec.prepares.values() if a is not None]
            stages += [("finish", a, b) for a, b in rec.finishes.values()]
            stages += [("denoise", b.t0, b.t1) for b in rec.batches]
            summary = tracer.summary(stages)
            tracer.undo()
            run_rec = {
                "config": config, "window_s": window, "frames": frames,
                "batches": [b for b in rec.batches if t0 < b.t1 <= t1],
                "completed": completed, "prepares": dict(rec.prepares),
                "segments": sum(1 for r in completed),
                "trace": summary,
                "peaks": peaks(dev["kind"]) if cuda else None,
            }
            for m in cell.per_layer:
                value = readers[m["name"]].read(run_rec)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            dev["busy_s"] = summary.get("busy_s", 0.0)
            dev["window_s"] = summary["window_s"]
            fams = sorted(summary["families"].items(), key=lambda kv: -kv[1])[:10]
            breakdown = {"device_ops": [[k, v] for k, v in fams],
                         "idle_gaps": summary.get("idle_gaps", [])}
            log(f"trace: {summary['kernels']} device ops, {len(summary['entries'])} entry calls "
                f"in {summary['window_s']:.3f} s on {summary['thread']}, "
                f"reduced in {summary['reduce_s']:.1f} s")
            log("trace: top kernels " + json.dumps([[n[:90], v] for n, v in summary["top"]]))

        # the program's state goes before the reference runs
        captures = {k: dict(v) for k, v in rec.captures.items()}
        for cap in captures.values():
            for key in ("audio", "latents"):
                if cap.get(key) is not None:
                    cap[key] = cap[key].float().cpu()
        spies.undo()
        rec_batches = list(rec.batches)
        del state, pipe, spies, clients, rec
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t_check = time.perf_counter()
        check.set_reference_numerics()
        models = check.Models(config, seed, device)
        numbers = {"audio_rel_l2": math.inf, "latents_rel_l2": math.inf, "frames_rms": math.inf}
        notes = []
        if models.signatures() != sigs:
            notes.append("the reference's parameters are not the program's")
        ccfg = config["check"]
        pool_ok = [r for r in measured if r.captured and r.status == "completed"
                   and r.job_id in captures and captures[r.job_id].get("latents") is not None
                   and captures[r.job_id].get("frames")]
        chosen = check.choose(pool_ok, lambda r: captures[r.job_id]["windows"], config, seed) \
            if pool_ok else []
        if not chosen:
            notes.append("no request submitted in the window completed")
        if not notes:
            numbers = {k: 0.0 for k in numbers}
            ref_av = check.Avatar(avatar["video"], avatar["bundle"], res)
            for r in chosen:
                cap = captures[r.job_id]
                got = {"audio": cap["audio"], "latents": cap["latents"],
                       "frames": np.concatenate(cap["frames"])}
                got_n = check.judge(models, config, ref_av, r.clip, got, region)
                numbers = {k: max(numbers[k], got_n[k]) for k in numbers}
        del models
        check_s = time.perf_counter() - t_check
        ok, rows = check.verdict(numbers, ccfg["limits"])
        failed = sum(1 for r in measured if r.status != "completed") + (0 if drained else 1)
        correct = bool(ok and not notes and failed == 0 and frames > 0)
        for note in notes:
            log(f"check: {note}")
        for r in measured:
            if r.status != "completed":
                log(f"request {r.job_id} {r.status}: {r.error}")
        log(f"check: {len(chosen)} requests, "
            f"{sum(captures[r.job_id]['windows'] for r in chosen)} windows, judged in {check_s:.1f} s")
        result = {"correct": correct, "attempted": len(measured), "failed": failed,
                  "metrics": metrics, "device": dev}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["run"] = {"window_s": window, "requests_completed": len(completed),
                         "batches": sum(1 for b in rec_batches if t0 < b.t1 <= t1),
                         "frames": frames, "latencies_s": sorted(lat_s),
                         "check_s": check_s, "setup_s": setup_s,
                         "checked": [r.job_id for r in chosen]}
        result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from lsbench.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device (torch.cuda.is_available() is false)")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{torch.cuda.device_count()} CUDA devices, the cell needs {cell.chips}")
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"modules of the JAX side are loaded: {found}")
        return 3
    for name, row in result["checks"].items():
        log(f"check {name} {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
