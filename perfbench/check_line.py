"""Check a run's last line against BENCHMARK.json.

    python3 perfbench/check_line.py --workload <cell> --trace <0|1> [FILE]

reads the last non-empty line of FILE (default standard input) and
prints "ok" or each fault, exiting 1 on a fault. `check_manifest` holds
BENCHMARK.json itself to the rules a line is read by: names, units, the
keys each entry may have, and which metric each cell reports.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
E2E_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves",
              "workloads"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}


def line_text(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def cell_metrics(manifest: dict, cell: str, trace: int) -> list[dict]:
    """The cell's end_to_end metrics (trace 0) or per_layer ones (trace
    1): those that list it, or list no cells and move a metric it
    reports."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def check_manifest(m: dict) -> list[str]:
    bad = []
    if set(m) != TOP:
        bad.append(f"top-level keys {sorted(m)}")
    cells = {c["name"] for c in m.get("workloads", [])}
    configs = {c["name"] for c in m.get("configs", [])}
    for c in m.get("configs", []):
        if set(c) != CONFIG_KEYS:
            bad.append(f"config {c.get('name')} keys {sorted(c)}")
        if not NAME.match(c["name"]) or not line_text(c["why"]) \
                or not line_text(c["source"]):
            bad.append(f"config {c['name']}: name, why or source")
        if any(not NAME.match(k) for k in c["reduced"]) \
                or len(c["reduced"]) > 16:
            bad.append(f"config {c['name']}: reduced")
    seen = set()
    for c in m.get("workloads", []):
        if set(c) != CELL_KEYS:
            bad.append(f"cell {c.get('name')} keys {sorted(c)}")
        if not (NAME.match(c["name"]) and NAME.match(c["traffic"])):
            bad.append(f"cell {c['name']}: name or traffic")
        if c["config"] not in configs:
            bad.append(f"cell {c['name']}: no config {c['config']}")
        if c["chips"] not in (1, 4) or not line_text(c["why"]):
            bad.append(f"cell {c['name']}: chips or why")
        if (c["config"], c["traffic"]) in seen:
            bad.append(f"cell {c['name']}: pair repeated")
        seen.add((c["config"], c["traffic"]))
    e2e_names = set()
    for e in m.get("end_to_end", []):
        if not set(e) <= E2E_KEYS or not E2E_KEYS - {"workloads"} <= set(e):
            bad.append(f"metric {e.get('name')} keys {sorted(e)}")
        if not (NAME.match(e["name"]) and UNIT.match(e["unit"])):
            bad.append(f"metric {e['name']}: name or unit")
        if e["better"] not in ("lower", "higher") \
                or e["source"] not in ("host_clock", "device_trace") \
                or not 0.01 <= e["bound"] <= 0.25:
            bad.append(f"metric {e['name']}: better, source or bound")
        if not set(e.get("workloads", [])) <= cells:
            bad.append(f"metric {e['name']}: unknown cells")
        e2e_names.add(e["name"])
    if "setup_s" not in e2e_names:
        bad.append("no setup_s")
    layers_seen = set()
    for p in m.get("per_layer", []):
        if not set(p) <= LAYER_KEYS or not LAYER_KEYS - {"workloads"} \
                <= set(p):
            bad.append(f"metric {p.get('name')} keys {sorted(p)}")
        if not (NAME.match(p["name"]) and UNIT.match(p["unit"])):
            bad.append(f"metric {p['name']}: name or unit")
        if p["source"] not in ("device_trace", "program_span",
                               "program_counter", "host_clock") \
                or p["better"] not in ("lower", "higher") \
                or not line_text(p["layer"]) or p["moves"] not in e2e_names:
            bad.append(f"metric {p['name']}: source, better, layer or moves")
        for cell in p.get("workloads", []):
            if cell not in cells or p["moves"] not in {
                    e["name"] for e in cell_metrics(m, cell, 0)}:
                bad.append(f"metric {p['name']}: cell {cell} does not "
                           f"report {p['moves']}")
        layers_seen.add(p["name"])
    names = [x["name"] for k in ("end_to_end", "per_layer")
             for x in m.get(k, [])]
    if len(names) != len(set(names)):
        bad.append("two metrics share a name")
    for c in m.get("workloads", []):
        e2e = cell_metrics(m, c["name"], 0)
        if not any(e["name"] == "setup_s" for e in e2e) or len(e2e) < 2 \
                or not cell_metrics(m, c["name"], 1):
            bad.append(f"cell {c['name']}: setup_s, another end-to-end "
                       f"and a per-layer metric")
    return bad


def check_line(line: str, manifest: dict, cell: str, trace: int) -> list:
    bad = []
    try:
        r = json.loads(line)
    except json.JSONDecodeError as e:
        return [f"not JSON: {e}"]
    if not isinstance(r, dict):
        return ["not an object"]
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        if k not in r:
            bad.append(f"missing {k}")
    if bad:
        return bad
    if not isinstance(r["correct"], bool):
        bad.append("correct is not a bool")
    for k in ("attempted", "failed"):
        if not isinstance(r[k], int) or r[k] < 0:
            bad.append(f"{k} is not a count")
    cells = {c["name"]: c for c in manifest["workloads"]}
    want = cell_metrics(manifest, cell, trace)
    got = r["metrics"]
    for m in want:
        v = got.get(m["name"])
        if v is None:
            bad.append(f"metrics lacks {m['name']}")
            continue
        if not isinstance(v, dict) or v.get("unit") != m["unit"] \
                or not isinstance(v.get("value"), (int, float)) \
                or isinstance(v.get("value"), bool) \
                or not math.isfinite(v["value"]):
            bad.append(f"{m['name']}: {v}")
            continue
        x = v["value"]
        if m["unit"] == "%" and not 0 <= x <= 100:
            bad.append(f"{m['name']} {x} outside 0-100 %")
        if ("roofline" in m["name"] or "mfu" in m["name"]) and x <= 0:
            bad.append(f"{m['name']} {x} not above 0")
        if not trace and x <= 0:
            bad.append(f"{m['name']} {x} not above 0")
    extra = set(got) - {m["name"] for m in want}
    if extra:
        bad.append(f"metrics not declared for the cell: {sorted(extra)}")
    for k in got:
        if not NAME.match(k) or not UNIT.match(str(got[k].get("unit", ""))):
            bad.append(f"name or unit of {k}")
    d = r["device"]
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        if k not in d:
            bad.append(f"device lacks {k}")
    if d.get("platform") != "gpu":
        bad.append(f"platform {d.get('platform')}")
    if d.get("count") != cells[cell]["chips"]:
        bad.append(f"count {d.get('count')}")
    if not isinstance(d.get("memory_peak_bytes"), int) \
            or d["memory_peak_bytes"] <= 0:
        bad.append("memory_peak_bytes")
    if trace:
        b, w = d.get("busy_s"), d.get("window_s")
        if not (isinstance(b, (int, float)) and isinstance(w, (int, float))
                and 0 < b <= w):
            bad.append(f"busy_s {b} window_s {w}")
        bd = r.get("breakdown")
        if bd is not None:
            for k in ("device_ops", "idle_gaps"):
                xs = bd.get(k, [])
                if len(xs) > 10 or any(
                        len(x) != 2 or not isinstance(x[0], str)
                        or not isinstance(x[1], (int, float)) for x in xs):
                    bad.append(f"breakdown {k}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    ap.add_argument("file", nargs="?")
    ap.add_argument("--manifest", default=os.path.join(ROOT,
                                                       "BENCHMARK.json"))
    args = ap.parse_args(argv)
    with open(args.manifest) as f:
        manifest = json.load(f)
    text = open(args.file).read() if args.file else sys.stdin.read()
    lines = [x for x in text.splitlines() if x.strip()]
    bad = check_manifest(manifest)
    bad += check_line(lines[-1] if lines else "", manifest, args.workload,
                      args.trace)
    print("ok" if not bad else "\n".join(bad))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
