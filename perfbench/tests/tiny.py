"""A throwaway copy of the benchmark with a tiny configuration, tiny
mixes and their cells, for driving whole runs on the CPU.

make_root(tmp) copies perfbench/ into tmp, adds only new files (a
configuration, two mixes, their limits, a per-layer metric's reader) and
writes a BENCHMARK.json that names the new cells and metric beside the
real ones: what a later change that adds a cell or a metric does."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

TINY = {"hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "vocab_size": 512, "max_position_embeddings": 1024,
        "rms_norm_eps": 1e-05, "rope_theta": 10000.0}
MIXES = {
    "tiny_seq": {"driver": "sequence", "clients": 1, "max_seq": 256,
                 "chunk": 8, "strata": 8, "order_seed": 1,
                 "prompt": {"dist": "lognormal", "median": 50, "sigma": 0.8,
                            "min": 8, "max": 200},
                 "output": {"dist": "fixed", "value": 24},
                 "greedy_share": 1.0, "temperature": 0.7, "top_p": 0.9,
                 "ramp_s": 0, "trace_s": 0.2,
                 "check": {"served_tokens": 40, "max_requests": 3}},
    "tiny_batch": {"driver": "batch", "clients": 4, "slots": 4,
                   "max_seq": 256, "chunk": 4, "strata": 8,
                   "order_seed": 2,
                   "prompt": {"dist": "uniform", "min": 8, "max": 180},
                   "output": {"dist": "uniform", "min": 8, "max": 24},
                   "greedy_share": 0.5, "temperature": 0.7, "top_p": 0.9,
                   "ramp_s": 0.3, "trace_s": 0.5,
                   "check": {"served_tokens": 40, "max_requests": 4}},
}
LIMIT = 0.02  # tiny cells, 8 seeds each: program up to 0.0052, fp8 control from 0.030


def make_root(tmp: str, mixes=MIXES, limit: float = LIMIT) -> str:
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(BENCH, os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(root, "perfbench", "configs", "tiny.json"),
              "w") as f:
        json.dump(TINY, f)
    manifest["configs"].append({"name": "tiny", "source": "a test",
                                "file": "perfbench/configs/tiny.json",
                                "reduced": [], "why": "a test"})
    for name, mix in mixes.items():
        with open(os.path.join(root, "perfbench", "mixes", f"{name}.json"),
                  "w") as f:
            json.dump(mix, f)
        cell = f"tiny.{name}"
        with open(os.path.join(root, "perfbench", "limits", f"{cell}.json"),
                  "w") as f:
            json.dump({"widest_gap": limit}, f)
        manifest["workloads"].append({"name": cell, "config": "tiny",
                                      "traffic": name, "chips": 1,
                                      "why": "a test"})
        like = {"batch": "yi-6b.serve_long",
                "sequence": "mistral-7b.decode_b1"}[mix["driver"]]
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    # a per-layer metric of its own, one for each kind of cell: a reader
    # file and an entry
    for name, moves, driver in (("tiny_rows", "output_tok_s", "batch"),
                                ("tiny_rows.b1", "b1_tok_s", "sequence")):
        with open(os.path.join(root, "perfbench", "metrics", f"{name}.py"),
                  "w") as f:
            f.write("def read(ctx):\n    return float(len(ctx.rows.rows))\n")
        manifest["per_layer"].append({
            "name": name, "unit": "rows", "better": "higher",
            "source": "program_counter", "layer": "model step",
            "moves": moves, "workloads": [f"tiny.{n}" for n, m in
                                          mixes.items()
                                          if m["driver"] == driver]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return root


class Args:
    def __init__(self, workload, seed=2**31 + 17, seconds=1.5, trace=0):
        self.workload, self.seed = workload, seed
        self.seconds, self.trace = seconds, trace
