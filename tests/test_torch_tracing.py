"""The port's own tracing (utils/profiling.py) on the CPU: spans and
counters that exist only while a torch.profiler session runs, the
engines' spans nested as PERF.md names them, the batch engine's
attention-row counters against a hand count, prefill blocks and chunks
timed until their sync, graph captures counted, and trace_summary's
kernel families and spans table.

Imports torch and the port only.
"""

import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from llama_cu_awq_torch.config import ModelConfig
from llama_cu_awq_torch.engine import BatchEngine, InferenceEngine
from llama_cu_awq_torch.engine import graphs
from llama_cu_awq_torch.models import synthetic_params
from llama_cu_awq_torch.tools import trace_summary
from llama_cu_awq_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# head_dim 32: the attention_step kernel's rule takes it, so that
# attn_impl="fused_step" runs its plain version on the CPU
CFG = ModelConfig(dim=64, hidden_dim=160, n_layers=2, n_heads=2,
                  n_kv_heads=1, vocab_size=512, seq_len=256)
SHORT = [1, 5, 9, 100, 7]                          # forced
LONG = [1] + [(17 * i) % 500 + 3 for i in range(199)]  # two blocks


@pytest.fixture(autouse=True)
def counters_cleared():
    """Each test starts and ends with no tracing counters."""
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.fixture(scope="module")
def params():
    return synthetic_params(CFG, device="cpu")


def _batch(params, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("chunk_size", 4)
    kw.setdefault("max_seq", 256)
    return BatchEngine(params, CFG, None, device="cpu", **kw)


def _seq(params):
    return InferenceEngine(params, CFG, None, temperature=0.0, max_seq=256,
                           device="cpu")


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _spans(prof, tmp_path) -> list[tuple[float, float, str]]:
    """(start, end, name) of the session's user annotations, by start."""
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation")


def _children(spans, parent) -> list[str]:
    a, b, _ = parent
    return [n for s, e, n in spans if a <= s and e <= b and (s, e) != (a, b)]


@pytest.fixture
def no_record_function(monkeypatch):
    """record_function raises: a span made with the profiler off would
    fail the test."""
    def refuse(*args, **kw):
        raise AssertionError("record_function made with the profiler off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_span_off_is_one_shared_null_context(no_record_function):
    profiling.reset_counters()
    assert not profiling.enabled()
    a, b = profiling.span("batch.step"), profiling.span("seq.wait")
    assert a is b
    with a:
        pass
    profiling.count("x", 3)
    profiling.add_ms("y", 1.5)
    assert profiling.COUNTERS == {} and profiling.counters() == {}


def test_engines_count_and_record_nothing_with_the_profiler_off(
        params, no_record_function):
    profiling.reset_counters()
    be = _batch(params, attn_impl="fused_step")
    be.submit(SHORT, max_new=6)
    be.submit(LONG, max_new=3)
    be.run()
    _seq(params).generate_benchmark(SHORT, 12)
    assert profiling.COUNTERS == {}


def test_counters_hold_only_the_session(params):
    profiling.reset_counters()
    be = _batch(params, attn_impl="fused_step")
    be.submit(SHORT, max_new=20)
    be.step()                                   # before: not counted
    with _session():
        assert profiling.enabled()
        be.step()
    inside = profiling.counters()
    be.step()                                   # after: not counted
    assert profiling.counters() == inside
    assert inside["attention_steps"] == 4
    # the CPU times nothing
    assert "decode_device_ms" not in inside
    assert "prefill_blocks" not in inside
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_batch_step_spans_nest_in_order(params, tmp_path):
    be = _batch(params)
    be.submit(SHORT, max_new=4)
    be.submit(LONG, max_new=4)
    with _session() as prof:
        be.step()
    spans = _spans(prof, tmp_path)
    steps = [s for s in spans if s[2] == "batch.step"]
    assert len(steps) == 1
    kids = _children(spans, steps[0])
    # the staging slot's wait (batch.wait inside batch.prefill and
    # batch.dispatch) is absent on the CPU: no pinned staging there
    assert kids == ["batch.admit", "batch.prefill", "batch.dispatch",
                    "batch.wait", "batch.route"]


def test_run_and_spec_rounds_open_the_same_spans(params, tmp_path):
    be = _batch(params, spec="ngram", spec_k=3)
    be.submit([1, 5, 9, 13, 5, 9, 13, 5, 9], max_new=6)
    with _session() as prof:
        be.run()
    names = {n for _, _, n in _spans(prof, tmp_path)}
    assert {"batch.step", "batch.admit", "batch.dispatch", "batch.wait",
            "batch.route"} <= names


def test_sequence_request_spans(params, tmp_path):
    eng = _seq(params)
    with _session() as prof:
        eng.generate_benchmark(LONG[:40], 48)
    spans = _spans(prof, tmp_path)
    req = [s for s in spans if s[2] == "seq.request"]
    assert len(req) == 1
    kids = _children(spans, req[0])
    assert kids[0] == "seq.reset" and kids[1] == "seq.prompt"
    assert kids.count("seq.decode") == 1    # 9 tokens: one chunk of 16
    assert kids[-1] == "seq.wait"           # the final read of the tokens
    assert set(kids) == {"seq.reset", "seq.prompt", "seq.decode",
                         "seq.wait"}


def test_attention_rows_against_a_hand_count(params):
    """Two slots, chunk 4, cache 256 (windows 128 and 256). Step 1: slot
    0 takes a 5-token forced prompt from position 0; slot 1 prefills the
    first block of a 200-token prompt and parks at the dead tail rows,
    256 - 4 = 252. The chunk's window is the bucket of 0 + 4, 128. Slot 0
    reads min(0 + j, 128) rows at step j: 0 + 1 + 2 + 3 = 6; slot 1
    min(252 + j, 128) = 128 at each of the 4 steps: 512."""
    profiling.reset_counters()
    be = _batch(params, attn_impl="fused_step")
    be.submit(SHORT, max_new=8)
    be.submit(LONG, max_new=8)
    with _session():
        be.step()
    c = profiling.counters()
    assert c["attention_steps"] == 4
    assert c["attention_rows_active"] == 6
    assert c["attention_rows_parked"] == 512
    assert "attention_plain_steps" not in c
    # step 2: slot 1's last block ends its prefill at position 199, and
    # both slots step at the window of 199 + 4, 256
    profiling.reset_counters()
    with _session():
        be.step()
    c = profiling.counters()
    assert c["attention_rows_active"] == (4 + 5 + 6 + 7) + (199 + 200
                                                             + 201 + 202)
    assert c["attention_rows_parked"] == 0


def test_plain_windows_count_plain_steps(params):
    """attn_impl "auto" runs plain attention below the 1024 window."""
    profiling.reset_counters()
    be = _batch(params)
    be.submit(SHORT, max_new=8)
    with _session():
        be.step()
    c = profiling.counters()
    assert c == {"attention_plain_steps": 4}


class _Event:
    """A timing event's stand-in on the CPU: 2 ms between any two."""

    def elapsed_time(self, other):
        return 2.0


def _timed(be):
    """The engine's timing events, as the card makes them while tracing."""
    be._mark = lambda: _Event() if profiling.enabled() else None
    be._event = _Event
    return be


def test_blocks_timed_with_every_slot_prefilling(params):
    """Both slots prefill two blocks and none decodes, so the step drains
    all four blocks, then steps both slots through their forced last
    token: every block is counted at that chunk's sync."""
    be = _timed(_batch(params))
    be.submit(LONG, max_new=4)
    be.submit(LONG, max_new=4)
    with _session():
        be.step()
    c = profiling.counters()
    assert c["prefill_blocks"] == 4 and c["prefill_device_ms"] == 8.0
    assert c["decode_steps"] == 4 and c["decode_device_ms"] == 2.0
    assert be._timed == []


def test_timed_launches_count_after_the_profiler_stops(params):
    """A chunk dispatched while tracing and synced after the session
    (run()'s lookahead, the server's thread) still counts its blocks and
    steps; one dispatched after the session counts nothing."""
    be = _timed(_batch(params))
    be.submit(LONG, max_new=8)
    be.submit(SHORT, max_new=8)
    with _session():
        chunk = be._dispatch_chunk()
    be._process_chunk(chunk)
    c = profiling.counters()
    assert c["prefill_blocks"] == 1 and c["decode_steps"] == 4
    be.step()
    assert profiling.counters() == c


class _CPUCaptureSet(graphs.GraphSet):
    """GraphSet.capture's bookkeeping without a card: its split capture
    runs the body and returns a graph of nothing."""

    def __init__(self):
        self.device = torch.device("cpu")
        self.stream = None
        self.graphs = {}

    def split_capture(self, body):
        body()
        return graphs.Graph(None, ({}, {}), 0.0, 0)


def test_captures_counted_and_traced(monkeypatch, tmp_path):
    for fn in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a, **k: 0)
    # the process's own record stays as it was
    monkeypatch.setattr(graphs, "CAPTURES", {"graphs": 0, "seconds": 0.0})
    before = dict(graphs.CAPTURES)
    gs = _CPUCaptureSet()
    with _session() as prof:
        g = gs.capture(lambda: None)
    gs.capture(lambda: None)                    # counted with tracing off
    assert graphs.CAPTURES["graphs"] == before["graphs"] + 2
    assert graphs.CAPTURES["seconds"] >= before["seconds"] + \
        g.capture_seconds
    assert [n for _, _, n in _spans(prof, tmp_path)] == ["graph.capture"]


def _seen_on_card():
    out = []
    fams = os.path.join(ROOT, "perfbench", "families")
    for f in sorted(os.listdir(fams)):
        with open(os.path.join(fams, f)) as fh:
            fam = json.load(fh)
        out += [(n, set(fam["kernels"]) | set(fam.get("epilogue", ())))
                for n in fam["seen_on_card"]["names"]]
    return out


@pytest.mark.parametrize("name,families", _seen_on_card())
def test_trace_summary_family_of_port_kernels(name, families):
    """Port kernels live in anonymous namespaces: the family keeps
    '(anonymous namespace)::' and drops the parameter list."""
    assert trace_summary.family(name) in families


def _annot(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "void k<1>(int)", "ts": ts,
            "dur": dur}


def test_trace_summary_spans_table(tmp_path, capsys):
    """Self time is a span less its children; the card's idle time goes
    to the innermost span it falls in, once."""
    events = [
        _annot("batch.step", 0, 1000),
        _annot("batch.dispatch", 100, 300),     # 100-400
        _annot("batch.wait", 500, 400),         # 500-900
        _annot("batch.step", 2000, 500),
        _annot("batch.wait", 2100, 100),        # 2100-2200
        _kernel(150, 600),                      # busy 150-750
        _kernel(2050, 400),                     # busy 2050-2450
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    res = trace_summary.summarize(str(tmp_path))
    sp = res["spans"]
    assert sp["batch.step"]["count"] == 2
    assert sp["batch.step"]["self_ms"] == pytest.approx(
        (1000 - 300 - 400 + 500 - 100) / 1e3)
    # step 1 idle: 0-150 and 750-1000, less the children's 100-150 and
    # 750-900; step 2: 2000-2050 and 2450-2500
    assert sp["batch.step"]["idle_ms"] == pytest.approx(0.3)
    assert sp["batch.dispatch"]["idle_ms"] == pytest.approx(0.05)
    assert sp["batch.wait"]["idle_ms"] == pytest.approx(0.15)
    assert sp["batch.wait"]["count"] == 2
    assert "program spans" in capsys.readouterr().out


def test_trace_summary_spans_of_a_cpu_run(params, tmp_path, capsys):
    """A CPU trace has spans and no device: the table gives no idle."""
    eng = _seq(params)
    with profiling.profile_trace(str(tmp_path)):
        eng.generate_benchmark(SHORT, 12)
    res = trace_summary.summarize(str(tmp_path))
    assert res["spans"]["seq.request"]["count"] == 1
    assert res["spans"]["seq.request"]["idle_ms"] is None
    assert "seq.decode" in capsys.readouterr().out
