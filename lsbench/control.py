"""The control of a cell's ``correct``: the plain reference one precision
below the configuration's (``reference/numerics.py`` mode ``control``: fp8
operands for the products the configuration runs in bfloat16, 4-bit codes
for its int8 convolutions, bfloat16 operands for whisper's float32) put in
the program's place, and judged by the float32 reference as a run judges
the program: the same inputs from the seed, the same number of requests,
the same three numbers. A sound limit lies below what it reads.

    python3 lsbench/control.py --workload <name> --seeds <n> [<n> ...]

One JSON line a seed: the numbers beside the cell's limits. Not part of a
benchmark run; it needs the card the cell runs on (``--device cpu`` runs
it at whatever size the workload's configuration has, for tests).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control(workload: str, seed: int, device: str = "cuda", bench_path: str = None,
            traffic_dir: str = None) -> dict:
    import torch

    from lsbench import check
    from lsbench.inputs import clip_pool, write_avatar
    from lsbench.spec import load_cell

    cell = load_cell(workload, bench_path, traffic_dir)
    config, traffic = cell.config, cell.traffic
    work = tempfile.mkdtemp(prefix="lsbench-control-", dir=tempfile.gettempdir())
    try:
        t0 = time.perf_counter()
        res = config["data"]["resolution"]
        av = traffic["avatar"]
        avatar = write_avatar(av, seed, work, res, torch.device(device))
        os.makedirs(os.path.join(work, "clips"))
        pool = clip_pool(traffic["clips"], seed, os.path.join(work, "clips"))
        region = check.crop_region(avatar["boxes"], (av["height"], av["width"]))
        check.set_reference_numerics()
        ref_av = check.Avatar(avatar["video"], avatar["bundle"], res)
        low = check.Models(config, seed, device, mode="control")
        f32 = check.Models(config, seed, device)
        numbers = {"audio_rel_l2": 0.0, "latents_rel_l2": 0.0, "frames_rms": 0.0}
        f, fps = config["data"]["num_frames"], config["data"]["video_fps"]
        chosen = check.choose(pool, lambda item: -(-int(item[0] * fps + 1) // f), config, seed)
        for _, clip in chosen:
            got = check.produce(low, config, ref_av, clip, region)
            n = check.judge(f32, config, ref_av, clip, got, region)
            numbers = {k: max(numbers[k], n[k]) for k in numbers}
        ok, rows = check.verdict(numbers, config["check"]["limits"])
        return {"workload": workload, "seed": seed, "correct": ok,
                "requests": [s for s, _ in chosen], "seconds": time.perf_counter() - t0,
                "checks": {k: {"value": v, "limit": lim} for k, v, lim in rows}}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
