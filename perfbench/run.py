"""The benchmark of llama_cu_awq_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. BENCHMARK.json names the cell's configuration (configs/<name>.json)
and traffic mix (mixes/<name>.json); the mix names its driver
(drivers/<name>.py). A run makes the weights on the card from the seed,
builds the engine and warms every graph the mix can ask for (set-up),
drives the mix for the window, then judges the served tokens against
the plain reference (judge.py) and prints one JSON line. With --trace 1
it traces part of the window with torch.profiler and prints the cell's
per-layer metrics (metrics/<name>.py) instead of its end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "llama_cu_awq_tpu")


def set_env(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    nothing that loads JAX."""
    cache = os.path.join(root, "build", "perfbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Tracer:
    """The traced part of a window: torch.profiler around it, the
    trace.WINDOW annotation inside, the card synchronized at both ends,
    and the launch counters read at both ends."""

    def __init__(self, sync):
        self.sync = sync
        self.started = self.stopped = False
        self.dir = tempfile.mkdtemp(prefix="perfbench-trace-")

    def prime(self):
        """One empty profiling session, in set-up: the profiler's first
        start in a process sets up CUPTI, which takes seconds."""
        from perfbench import profiling
        t = time.perf_counter()
        prof = profiling.start()
        self.sync()
        prof.stop()
        say(f"trace: the profiler's first session took "
            f"{time.perf_counter() - t:.3f} s in set-up")

    def start(self):
        from perfbench import port, profiling
        from perfbench.trace import WINDOW
        import torch
        self.sync()
        self.host = [time.perf_counter()]
        self._prof = profiling.start()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()
        self.launches0 = port.launches()
        self.started = True
        self.host.append(time.perf_counter())

    def stop(self):
        """The traced part's end; the trace is written later (load)."""
        from perfbench import port
        self.sync()
        self.host.append(time.perf_counter())
        self.launches1 = port.launches()
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        self.stopped = True
        self.host.append(time.perf_counter())

    def delta(self) -> dict:
        v0, v1 = self.launches0[1], self.launches1[1]
        return {k: n - v0.get(k, 0) for k, n in v1.items()
                if n != v0.get(k, 0)}

    def load(self):
        """Write the trace, read it, and remove it."""
        from perfbench import profiling
        from perfbench.trace import Trace
        try:
            path = profiling.write(self._prof, self.dir)
            t = time.perf_counter()
            tr = Trace.load(path)
            h = self.host
            say(f"trace: start {h[1] - h[0]:.3f} s, traced {h[2] - h[1]:.3f}"
                f" s on the host clock, stop {h[3] - h[2]:.3f} s, written in"
                f" {t - h[3]:.3f} s after, read in "
                f"{time.perf_counter() - t:.3f} s")
            return tr
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)

    def discard(self):
        if self.started and not self.stopped:
            self._prof.stop()
        shutil.rmtree(self.dir, ignore_errors=True)


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the configuration's widths, the
    traced window (trace.Trace), the launch counters' growth over it, the
    harness's records of it (drivers/common.Rows), and its length and
    busy seconds."""

    shape: object
    trace: object
    launches: dict
    rows: object
    block_width: int
    window_s: float
    busy_s: float
    notes: dict = dataclasses.field(default_factory=dict)

    def note(self, key: str, text: str) -> None:
        self.notes[key] = text

    def block_rows(self):
        """(real rows, launched rows) of the prompt blocks in the window,
        or None without any."""
        from perfbench import work
        blocks = work.passes(self.launches, self.shape).get(
            self.block_width, 0)
        if not blocks:
            return None
        padded = blocks * self.block_width
        return padded - self.rows.block_padding, padded


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not readable"
    return out


def run(args, *, device: str = "cuda",
        root: str = ROOT) -> tuple[int, dict | None]:
    """One run; returns (exit code, result or None)."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in manifest["workloads"]}
    if args.workload not in cells:
        say(f"unknown workload {args.workload!r}; known: {sorted(cells)}")
        return 2, None
    cell = cells[args.workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench = os.path.join(root, "perfbench")
    conf = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    mix = load_json(os.path.join(bench, "mixes", f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(bench, "limits",
                                    f"{cell['name']}.json"))

    import torch
    torch.set_num_threads(4)
    if device == "cuda":
        if not torch.cuda.is_available():
            say("no CUDA device: torch.cuda.is_available() is False")
            return 3, None
        if torch.cuda.device_count() < cell["chips"]:
            say(f"the cell asks for {cell['chips']} cards, "
                f"{torch.cuda.device_count()} are visible")
            return 3, None
    from perfbench import judge, port, weights as wmod, work
    from perfbench.check_line import cell_metrics
    if device == "cuda":
        say(f"card: {power_line()}; peaks used: {work.PEAK_FLOPS:.4g} "
            f"FLOP/s, {work.PEAK_BYTES:.4g} B/s (H100 SXM at 700 W)")
    dev = torch.device(device)
    shape = wmod.Shape.from_config(conf)
    w = wmod.make(shape, args.seed, dev)
    driver = load_module(os.path.join(bench, "drivers",
                                      f"{mix['driver']}.py"),
                         f"perfbench_driver_{mix['driver']}").Driver(
        shape, mix, w, args.seed, dev)
    driver.setup()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    tracer = Tracer(sync) if args.trace else None
    if tracer is not None:
        tracer.prime()
    try:
        res = driver.window(float(args.seconds), tracer)
    except BaseException:
        if tracer is not None:
            tracer.discard()
        raise
    setup_s = res["t0"] - T_START
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    say(f"set-up {setup_s:.3f} s; window {res['t1'] - res['t0']:.3f} s, "
        f"{res['requests']} requests, {res['output_tokens']} tokens; "
        f"graphs held after warm-up {driver.warm_graphs}, after the window "
        f"{driver.graphs_after}")
    if "thirds" in res:
        say("rate over each third of the window, tokens/s (a request's "
            "tokens spread over its time): "
            + ", ".join(f"{v:.3f}" for v in res["thirds"]))

    metrics, device_info, breakdown = {}, {}, None
    if args.trace:
        if not tracer.stopped:
            tracer.discard()
            say("the traced window never started")
            return 5, None
        tr = tracer.load()
        ctx = Context(shape, tr, tracer.delta(), driver.rows,
                      port.block(), tr.window_s, tr.busy_s())
        found = sorted(tr.families().items(), key=lambda kv: -kv[1][0])
        for m in cell_metrics(manifest, cell["name"], 1):
            reader = load_module(os.path.join(bench, "metrics",
                                              f"{m['name']}.py"),
                                 f"perfbench_metric_{m['name']}")
            v = reader.read(ctx)
            if v is None:
                say(f"metric {m['name']}: its source holds nothing in the "
                    f"traced window, so it is left out; kernel families "
                    f"found: {[f for f, _ in found]}")
                continue
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        for k, text in ctx.notes.items():
            say(f"{k}: {text}")
        say("kernel families in the traced window (seconds, launches): "
            + "; ".join(f"{f} {s:.6f} {n}" for f, (s, n) in found[:16]))
        device_info = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
        del tr
    else:
        for m in cell_metrics(manifest, cell["name"], 0):
            v = setup_s if m["name"] == "setup_s" else res.get(m["name"])
            if v is None:
                say(f"metric {m['name']}: no value in this run")
                continue
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the check, once the program's state is freed
    served = driver.served()
    driver.free()
    del driver
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    chk = mix["check"]
    sample = judge.pick(served, args.seed, chk["served_tokens"],
                        chk["max_requests"])
    t_chk = time.perf_counter()
    got = judge.gaps(w, sample) if sample else {"widest_gap": float("inf"),
                                                "compared_tokens": 0}
    say(f"check: {len(sample)} requests, {got['compared_tokens']} served "
        f"tokens against the reference in {time.perf_counter() - t_chk:.1f} s")
    # a gap that is not finite (no sample, a token outside the
    # vocabulary, a NaN) is printed as 1e30, which JSON can hold
    gap = got["widest_gap"] if math.isfinite(got["widest_gap"]) else 1e30
    check = {
        "widest_gap": {"value": gap, "limit": limits["widest_gap"]},
        "unanswered": {"value": res["failed"], "limit": 0},
        "compared_tokens": {"value": got["compared_tokens"],
                            "limit": chk["served_tokens"] // 2},
    }
    correct = (gap <= limits["widest_gap"]
               and res["failed"] == 0
               and got["compared_tokens"] >= chk["served_tokens"] // 2)
    bad = forbidden_modules()
    if bad:
        say(f"modules of JAX or the JAX package were loaded: {bad}")
        return 4, None
    result = {"correct": bool(correct), "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": (torch.cuda.get_device_name(0)
                                  if device == "cuda" else device),
                         "count": int(cell["chips"]),
                         "memory_peak_bytes": peak, **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check
    for k, v in check.items():
        say(f"check {k} {v['value']} limit {v['limit']}")
    return 0, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_env(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    code, result = run(args)
    if code == 0:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
