"""Reading a torch.profiler Chrome trace.

The device categories, the busy union, the gaps and the kernel families
are copied from llama_cu_awq_torch/tools/trace_summary.py, so that the
yardstick does not move with the program. A traced window is the span of
the host annotation WINDOW that the run opens around it; everything is
clipped to it.
"""

from __future__ import annotations

import collections
import json
import re

# the categories of the card's own operations in a torch.profiler trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
WINDOW = "perfbench.window"


def _drop_params(s: str) -> str:
    """s without the parenthesised list that ends it (the parameter
    list), found by matching from the end, so that a name's own
    parentheses, as in '(anonymous namespace)::k(int)', stay."""
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
    and 'ns::k<8, float>(...)' are one family, 'ns::k'. (The program's
    tools/trace_summary.py cuts the parameter list from the first '(',
    which leaves nothing of a kernel in an anonymous namespace; this copy
    matches the list from the end.)"""
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


class Trace:
    """The device operations and host events of one traced window, in
    microseconds of the trace's clock."""

    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        marks = [e for e in xs if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise ValueError(f"the trace holds no {WINDOW} annotation")
        w = max(marks, key=lambda e: float(e["dur"]))
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        # (start, end, name) of the card's operations, clipped to the window
        self.device = sorted(
            (max(float(e["ts"]), self.t0),
             min(float(e["ts"]) + float(e["dur"]), self.t1), e["name"])
            for e in xs if e.get("cat") in DEVICE_CATS
            and float(e["ts"]) < self.t1
            and float(e["ts"]) + float(e["dur"]) > self.t0)
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in xs if e.get("cat") in HOST_CATS and e["name"] != WINDOW)
        self._families: dict[str, str] = {}

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the card's operations, as disjoint intervals."""
        out: list[list[float]] = []
        for s, e, _ in self.device:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def family_of(self, name: str) -> str:
        f = self._families.get(name)
        if f is None:
            f = self._families[name] = family(name)
        return f

    def families(self) -> dict[str, list]:
        """family -> [seconds, launches] over the window."""
        fam: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
        for s, e, name in self.device:
            f = fam[self.family_of(name)]
            f[0] += (e - s) / 1e6
            f[1] += 1
        return dict(fam)

    def family_seconds(self, kernels, epilogue=(), owners=()) -> tuple:
        """(seconds, launches) of the families in `kernels`, plus each
        launch of an `epilogue` family whose last preceding launch of an
        `owners` family (the kernels whose epilogue it may be) is one of
        `kernels`: an epilogue launch belongs to the matmul before it."""
        kernels, epilogue = set(kernels), set(epilogue)
        owners = set(owners) | kernels
        secs, n, last = 0.0, 0, None
        for s, e, name in self.device:
            f = self.family_of(name)
            if f in kernels:
                secs += (e - s) / 1e6
                n += 1
            elif f in epilogue and last in kernels:
                secs += (e - s) / 1e6
            if f in owners:
                last = f
        return secs, n

    def idle_gaps(self, top: int = 10, min_us: float = 20.0) -> list:
        """The card's idle time in the window, summed by the host event
        that was running where each gap of over min_us began (the
        innermost one), longest first."""
        by: dict[str, float] = collections.defaultdict(float)
        prev = self.t0
        gaps = []
        for a, b in self.busy_intervals() + [(self.t1, self.t1)]:
            if a - prev > min_us:
                gaps.append((prev, a))
            prev = max(prev, b)
        # sweep the host events in order of start, keeping those that may
        # still run; the innermost running one is the latest started
        active: list = []
        i = 0
        for a, b in gaps:
            while i < len(self.host) and self.host[i][0] <= a:
                active.append(self.host[i])
                i += 1
            while active and active[-1][1] < a:
                active.pop()
            name = active[-1][2] if active else "no host event"
            by[name[:80]] += (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def device_ops(self, top: int = 10) -> list:
        return sorted(([k[:80], v[0]] for k, v in self.families().items()),
                      key=lambda kv: -kv[1])[:top]
