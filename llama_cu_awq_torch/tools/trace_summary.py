"""Summarize a torch.profiler Chrome trace: device time per kernel,
launch count and mean, the card's busy share and the host's gaps.

The counterpart of the repository's tools/trace_summary.py, which reads
a jax.profiler xplane. This one reads the Chrome trace that
utils/profiling.py profile_trace writes (DIR/trace.json; the bench's and
the CLI's --profile DIR), and uses the standard library alone:

    python -m llama_cu_awq_torch.tools.trace_summary DIR_OR_TRACE.json
        [--top 40] [--module SUBSTR] [--families]

It prints the device busy ms over the traced span of the card's
operations and their occupancy; the gaps of more than 0.1 ms between two
of the card's operations, where the host had not queued the next one (as
chip_smoke.py's profile_run counts them); the top operations by device
time with their count and mean; with --families, the operations grouped
by kernel name with template arguments, parameter lists and numeric
suffixes taken off (the parameter list matched from the end, so that a
kernel in an anonymous namespace keeps its name). --module keeps only the
operations whose name holds SUBSTR (the xplane tool's filter on the
enclosing XLA module; a CUDA trace has no modules, so it filters on the
kernel name). A trace of a CPU run has no device operations: it says so,
and shows the host's operations.

Last, the program's spans (utils/profiling.py span: batch.*, seq.*,
graph.capture, every user annotation of the trace), one row a name: how
many, the host ms of their self time (a span less the spans inside it),
and the card's idle ms inside them, each idle stretch counted once, in
the innermost span that holds it (none on a trace without the card). The
table places the idle on the host's clock; it does not say whether the
host held the card there or the next operation was already queued, and a
trace's card timestamps may drift from the host's by milliseconds over a
few seconds, so read it as a rough placement.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import re
import sys

# the categories of the card's own operations in a torch.profiler trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GAP_US = 100.0  # a gap of more than 0.1 ms between the card's operations


def find_trace(path: str) -> str:
    """path itself, or the trace.json (else the newest *.json) under a
    directory."""
    if os.path.isfile(path):
        return path
    direct = os.path.join(path, "trace.json")
    if os.path.isfile(direct):
        return direct
    hits = sorted((os.path.join(root, f) for root, _, files in os.walk(path)
                   for f in files if f.endswith(".json")),
                  key=os.path.getmtime)
    if not hits:
        sys.exit(f"no trace .json under {path}")
    return hits[-1]


def load_events(path: str) -> list[dict]:
    with open(find_trace(path)) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _drop_params(s: str) -> str:
    """s without the parenthesised list that ends it (the parameter
    list), matched from the end, so that a name's own parentheses, as in
    '(anonymous namespace)::k(int)', stay."""
    s = s.rstrip()
    if not s.endswith(")"):
        return s
    depth = 0
    for i in range(len(s) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(s[i], 0)
        if depth == 0:
            return s[:i] if i else s
    return s


def family(name: str) -> str:
    """A kernel name without its template arguments, parameter list,
    return type and numeric suffixes: 'void ns::k<4, float>(int, ...)'
    and 'ns::k<8, float>(...)' are one family, 'ns::k'."""
    s = name
    if s.startswith("void "):
        s = s[5:]
    s = _drop_params(s)
    prev = None
    while prev != s:  # nested template arguments, innermost first
        prev = s
        s = re.sub(r"<[^<>]*>", "", s)
    s = re.sub(r"([._#]?\d+)+$", "", s.strip())
    return s or name


class _Idle:
    """The card's idle time inside any stretch of the trace: the union of
    its operations, with prefix sums for lookups."""

    def __init__(self, dev: list[dict]):
        merged: list[list[float]] = []
        for s, d in sorted((float(e["ts"]), float(e["dur"])) for e in dev):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], s + d)
            else:
                merged.append([s, s + d])
        self.starts = [a for a, _ in merged]
        self.ends = [b for _, b in merged]
        self.before = [0.0]  # busy time of the intervals before index i
        for a, b in merged:
            self.before.append(self.before[-1] + b - a)

    def _busy_to(self, t: float) -> float:
        """Busy time before t."""
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        return self.before[i - 1] + min(t, self.ends[i - 1]) \
            - self.starts[i - 1]

    def within(self, a: float, b: float) -> float:
        return (b - a) - (self._busy_to(b) - self._busy_to(a))


def span_table(events: list[dict], dev: list[dict]) -> dict:
    """name -> {count, self_ms, idle_ms} over the trace's user
    annotations, nested per thread; idle_ms None without device
    operations."""
    idle = _Idle(dev) if dev else None
    by_tid: dict = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation":
            a = float(e["ts"])
            # longer first at one start, so that a parent precedes its child
            by_tid[e.get("tid")].append((a, -(a + float(e["dur"])),
                                         e["name"]))
    table: dict = {}
    for spans in by_tid.values():
        spans.sort()
        stack: list = []  # [name, start, end, child µs, child idle µs]

        def close(sp):
            name, a, b, kids, kid_idle = sp
            row = table.setdefault(name, {"count": 0, "self_ms": 0.0,
                                          "idle_ms": None if idle is None
                                          else 0.0})
            row["count"] += 1
            row["self_ms"] += (b - a - kids) / 1e3
            inside = idle.within(a, b) if idle is not None else 0.0
            if idle is not None:
                row["idle_ms"] += (inside - kid_idle) / 1e3
            if stack:
                stack[-1][3] += b - a
                stack[-1][4] += inside

        for a, neg_b, name in spans:
            while stack and stack[-1][2] <= a:
                close(stack.pop())
            stack.append([name, a, -neg_b, 0.0, 0.0])
        while stack:
            close(stack.pop())
    return table


def summarize(path: str, top: int = 40, module: str | None = None,
              families: bool = False, out=None) -> dict:
    """Print the summary of the trace at path (a file or a directory) to
    out (default stdout) and return its numbers: device busy_ms, span_ms,
    occupancy, gaps, gap_ms, largest_gap_ms, device_ops, ops (name ->
    [ms, count]) and spans (span_table)."""
    out = out or sys.stdout
    events = load_events(path)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and (module is None or module in e.get("name", ""))]
    per_op: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for e in dev:
        per_op[e["name"]][0] += float(e["dur"])
        per_op[e["name"]][1] += 1
    busy_us = sum(float(e["dur"]) for e in dev)
    gaps, end, t_min = [], None, None
    for s, d in sorted((float(e["ts"]), float(e["dur"])) for e in dev):
        t_min = s if t_min is None else t_min
        if end is not None and s - end > GAP_US:
            gaps.append(s - end)
        end = s + d if end is None else max(end, s + d)
    span_us = (end - t_min) if dev else 0.0
    res = {"busy_ms": busy_us / 1e3, "span_ms": span_us / 1e3,
           "occupancy": busy_us / span_us if span_us else None,
           "gaps": len(gaps), "gap_ms": sum(gaps) / 1e3,
           "largest_gap_ms": max(gaps, default=0.0) / 1e3,
           "device_ops": len(dev),
           "ops": {k: [v[0] / 1e3, v[1]] for k, v in per_op.items()}}

    def say(line=""):
        print(line, file=out, flush=True)

    res["spans"] = span_table(events, dev)

    def say_spans():
        if not res["spans"]:
            return
        say("\n-- program spans: count, host self ms, device idle ms "
            "inside (innermost span) --")
        for name, row in sorted(res["spans"].items(),
                                key=lambda kv: -kv[1]["self_ms"]):
            idle = ("       n/a" if row["idle_ms"] is None
                    else f"{row['idle_ms']:10.3f}")
            say(f"{row['count']:8d} {row['self_ms']:10.3f} {idle}  "
                f"{name[:80]}")

    if not dev:
        say("no device operations in the trace (a CPU run, or the card "
            "was not traced): device busy 0.00 ms"
            + (f" (filter {module!r})" if module else ""))
        host: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
        for e in events:
            if e.get("cat") == "cpu_op":
                host[e["name"]][0] += float(e["dur"])
                host[e["name"]][1] += 1
        say(f"\n-- top {top} host operations by total time --")
        for name, (us, cnt) in sorted(host.items(),
                                      key=lambda kv: -kv[1][0])[:top]:
            say(f"{us / 1e3:10.3f} ms {cnt:8d} x {us / max(cnt, 1):9.1f} us"
                f"  {name[:100]}")
        say_spans()
        return res
    say(f"device busy: {res['busy_ms']:.2f} ms over {res['span_ms']:.2f} ms "
        f"span ({100 * res['occupancy']:.1f}% occupancy), "
        f"{len(dev)} operations")
    say(f"device gaps over 0.1 ms: {len(gaps)}, {res['gap_ms']:.3f} ms "
        f"(largest {res['largest_gap_ms']:.3f} ms)")
    say(f"\n-- top {top} device operations by total time --")
    for name, (us, cnt) in sorted(per_op.items(),
                                  key=lambda kv: -kv[1][0])[:top]:
        say(f"{us / 1e3:10.3f} ms {cnt:8d} x {us / max(cnt, 1):9.1f} us"
            f"  {name[:100]}")
    if families:
        fam: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
        for name, (us, cnt) in per_op.items():
            fam[family(name)][0] += us
            fam[family(name)][1] += cnt
        say("\n-- operation families (template arguments and numeric "
            "suffixes collapsed) --")
        for key, (us, cnt) in sorted(fam.items(),
                                     key=lambda kv: -kv[1][0])[:30]:
            say(f"{us / 1e3:10.3f} ms {cnt:8d} ev  {key[:90]}")
        res["families"] = {k: [v[0] / 1e3, v[1]] for k, v in fam.items()}
    say_spans()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="a trace .json or the directory holding "
                                  "trace.json")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--module", default=None, metavar="SUBSTR",
                    help="only the operations whose name holds SUBSTR")
    ap.add_argument("--families", action="store_true",
                    help="also group the operations into kernel families")
    args = ap.parse_args(argv)
    summarize(args.trace, top=args.top, module=args.module,
              families=args.families)
    return 0


if __name__ == "__main__":
    sys.exit(main())
