"""The control of the comparison: the plain reference put in the program's
place, in the nearest precision below the configuration's float32,
bfloat16 (the forecast runs no matrix product, so TF32 does not apply).

For each seed it draws the points a run keeps (``check.sample_points``
over cycles 1.. until ``max_points``, each cycle's warm start from
``warm.draws``), forecasts them with the reference in float64 and in
bfloat16, and compares the two as a run compares the program: the
control has to come out over the limit in at least one number.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed with the control's numbers beside the limits.
It is a test's and a measurement's tool, not part of a run.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from . import check, manifest


#: the control's precision, the nearest below the configuration's float32
CONTROL_DTYPE = "bfloat16"


def readings(workload: str, seed: int, sizes: dict = None) -> dict:
    """The control's numbers for one seed, at the cell's sizes (merged
    with ``sizes``)."""
    import shutil

    import numpy as np
    import torch

    from . import deploy, run, warm
    from .reference import run as reference

    cell = manifest.workload(workload)
    cfg = manifest.merge(manifest.config(cell["config"]), sizes or {})
    traffic = manifest.traffic(cell["traffic"])
    data_dir = tempfile.mkdtemp(prefix="roadsurf_control_")
    try:
        run_cfg = manifest.runner_config(cfg, traffic, data_dir)
        run.generate(cfg, run_cfg, seed, data_dir)
        from .reference.config import ModelSettings
        dt = ModelSettings.from_json(run_cfg).dt
        _, _, T = deploy.times(run_cfg, cfg["now"], dt)
        P = int(np.prod([run_cfg["points"]["grid"][k]
                         for k in ("ny", "nx")]))
        k = int(traffic["check"]["points_per_cycle"])
        n_cyc = max(1, int(traffic["check"]["max_points"]) // k)
        index, draws = [], []
        for c in range(1, n_cyc + 1):
            idx = check.sample_points(seed, c, P, k)
            d = warm.draws(seed, c, P, "cpu", traffic["warm_start"])
            index.append(idx)
            draws.append({n: v[idx] for n, v in d.items()})
        index = np.concatenate(index)
        draws = {n: torch.cat([d[n] for d in draws]) for n in draws[0]}
        inp = reference.inputs(run_cfg, cfg["now"], index)
        steps = np.arange(0, T, inp.settings.output_stride)
        t0 = time.perf_counter()
        ref = reference.forecast(inp, lambda st: warm.apply(st, draws),
                                 steps)
        t1 = time.perf_counter()
        ctl = reference.forecast(inp, lambda st: warm.apply(st, draws),
                                 steps, dtype=getattr(torch, CONTROL_DTYPE))
        t2 = time.perf_counter()
        numbers = check.compare_arrays(ctl.rows, ctl.state, ref.rows,
                                       ref.state)
        limits = check.load_limits(manifest.BENCH_DIR, workload)
        return {"workload": workload, "seed": seed, "points": len(index),
                "steps": T, "control": CONTROL_DTYPE,
                "reference_s": t1 - t0, "control_s": t2 - t1,
                "numbers": numbers, "limits": limits,
                "fails": [n for n in check.NUMBERS
                          if not numbers[n] <= limits[n]]}
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
