"""The readers of the program's counters (counters.py and the metrics
that read them) on a hand-built trace and given counters."""

import importlib.util
import os

import pytest

from perfbench import counters, work
from perfbench.run import Context
from perfbench.trace import WINDOW, Trace
from perfbench.weights import Shape

HERE = os.path.dirname(os.path.abspath(__file__))
METRICS = os.path.join(os.path.dirname(HERE), "metrics")
KERNEL = ("void (anonymous namespace)::attention_step_kernel<(KVFormat)0, "
          "__nv_bfloat16>(__nv_bfloat16 const*, void const*, int)")


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _x(name, ts, dur, cat):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def context(events, launches=None, shape=None):
    tr = Trace([_x(WINDOW, 0, 1000, "user_annotation")] + events)
    return Context(shape, tr, launches or {}, None, 128, tr.window_s,
                   tr.busy_s())


# a window of 1000 us; the attention_step family's two kernels take 390
# us of it
STEPS = [_x("batch.step", 0, 400, "user_annotation"),
         _x("batch.step", 500, 480, "user_annotation"),
         _x(KERNEL, 50, 150, "kernel"),
         _x("Memcpy HtoD", 530, 110, "gpu_memcpy"),
         _x(KERNEL, 700, 240, "kernel")]


YI = Shape.from_config({
    "hidden_size": 4096, "intermediate_size": 11008,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 4, "vocab_size": 64000,
    "max_position_embeddings": 4096, "rms_norm_eps": 1e-5,
    "rope_theta": 5e6})


def test_attention_roofline_from_given_counters(monkeypatch):
    """10 steps at B=8 over 32 layers, 30000 cache rows read: bytes =
    rows x the rows of every layer's keys and values + 320 launches x
    their own rows, over the 390 us of the family's two kernels."""
    c = {"attention_steps": 10, "attention_rows_active": 20000,
         "attention_rows_parked": 10000, "attention_plain_steps": 30}
    monkeypatch.setattr(counters, "tracing", lambda: dict(c))
    key = "attention_step/bf16/B8/H32/kv4/D128"
    ctx = context(STEPS, {key: 320, "int4_matmul_fused/gemv/x": 5}, YI)
    own = 8 * ((32 + 8) * 128 * 2 + 8 * 128 * 2 + 32 * 128 * 4 + 4
               + 2 * 128 * 4)
    want = (30000 * work.kv_row_bytes(YI) + 320 * own) / work.PEAK_BYTES \
        / 390e-6 * 100
    assert reader("attention_step_roofline")(ctx) == pytest.approx(want)
    note = ctx.notes["attention_step"]
    assert "= 320 (0 launches outside chunks)" in note
    assert "ran 10 of 40 chunk steps" in note
    assert reader("attention_parked_share")(ctx) == pytest.approx(100 / 3)


def test_counter_readers(monkeypatch):
    c = {"decode_device_ms": 96.0, "decode_steps": 8,
         "prefill_device_ms": 30.0, "prefill_blocks": 2}
    monkeypatch.setattr(counters, "tracing", lambda: dict(c))
    ctx = context(STEPS)
    assert reader("decode_step_ms")(ctx) == pytest.approx(12.0)
    assert reader("prefill_block_ms")(ctx) == pytest.approx(15.0)
    assert "0.126000 s" in ctx.notes["device_ms"]
    monkeypatch.setattr(counters, "captures",
                        lambda: {"graphs": 56, "seconds": 6.5})
    assert reader("graph_capture_s")(ctx) == 6.5


@pytest.mark.parametrize("name", ["attention_step_roofline",
                                  "attention_parked_share", "decode_step_ms",
                                  "prefill_block_ms", "graph_capture_s"])
def test_a_program_without_the_record_reads_nothing(monkeypatch, name):
    """A program that keeps no such counter (an older one) gives no
    value, and no error."""
    monkeypatch.setattr(counters, "tracing", lambda: None)
    monkeypatch.setattr(counters, "captures", lambda: None)
    assert reader(name)(context(STEPS, shape=YI)) is None


def test_counters_of_a_program_without_them(monkeypatch):
    from llama_cu_awq_torch.engine import graphs
    from llama_cu_awq_torch.utils import profiling
    monkeypatch.delattr(profiling, "counters")
    monkeypatch.delattr(graphs, "CAPTURES")
    assert counters.tracing() is None and counters.captures() is None
