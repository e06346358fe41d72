"""Readings for a cell's correctness limit, on the card.

    python3 perfbench/control.py --workload <cell> --seeds a,b,c
        [--seconds S] [--control 1]

For each seed, in one process: the run's weights, set-up and a short
window of the cell's own traffic, then the sample a run would judge
(judge.pick). It prints the program's widest gap against the float32
reference and, with --control 1, the widest gap of the tokens the fp8
control (reference/llama.py precision="fp8") puts first at the same
positions: the lower and the upper readings a limit is set between
(PERF.md). The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reading(root: str, cell_name: str, seed: int, seconds: float,
            control: bool, device: str = "cuda") -> dict:
    import torch
    from perfbench import judge, weights as wmod
    from perfbench.run import load_json, load_module
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = {c["name"]: c for c in manifest["workloads"]}[cell_name]
    conf_entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    bench = os.path.join(root, "perfbench")
    conf = load_json(os.path.join(root, conf_entry["file"]))
    mix = load_json(os.path.join(bench, "mixes", f"{cell['traffic']}.json"))
    shape = wmod.Shape.from_config(conf)
    w = wmod.make(shape, seed, torch.device(device))
    drv = load_module(os.path.join(bench, "drivers", f"{mix['driver']}.py"),
                      f"perfbench_driver_{mix['driver']}").Driver(
        shape, mix, w, seed, torch.device(device))
    drv.setup()
    res = drv.window(seconds)
    served = drv.served()
    drv.free()
    del drv
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    chk = mix["check"]
    sample = judge.pick(served, seed, chk["served_tokens"],
                        chk["max_requests"])
    out = judge.gaps(w, sample, control=control)
    out.update(seed=seed, cell=cell_name, failed=res["failed"],
               requests=res["requests"])
    del w
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench.run import set_env
    set_env(ROOT)
    rows = []
    for s in args.seeds.split(","):
        t = time.perf_counter()
        r = reading(ROOT, args.workload, int(s), args.seconds,
                    bool(args.control))
        r["seconds"] = time.perf_counter() - t
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {"cell": args.workload,
               "program_max": max(r["widest_gap"] for r in rows)}
    if args.control:
        summary["control_min"] = min(r["control_gap"] for r in rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
