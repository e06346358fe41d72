"""The work module's bytes and operations against hand counts."""

import json
import os

import pytest

from perfbench import work
from perfbench.weights import Shape

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def shape(name):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return Shape.from_config(json.load(f))


@pytest.mark.parametrize("name,qkv", [("mistral-7b-v0.1", 6144),
                                      ("yi-6b", 5120)])
def test_gemv_qkv_key(name, qkv):
    s = shape(name)
    assert s.dim + 2 * s.kv_dim == qkv
    key = f"int4_matmul_fused/gemv/prescale/m1/4096x{qkv}"
    l = work.Launch.parse(key)
    assert (l.kernel, l.flags, l.m, l.n_in, l.n_out) == \
        ("gemv", ("prescale",), 1, 4096, qkv)
    hand = (4096 * qkv // 2 + qkv * 32 * 2 + qkv * 32   # codes, scales, zeros
            + 4096 * 2 + 4 + 4096 * 4                    # x, ss, norm weight
            + qkv * 2)                                   # out
    assert work.w4_bytes(l) == hand
    assert work.w4_ops(l) == 2 * 4096 * qkv


@pytest.mark.parametrize("name,hid", [("mistral-7b-v0.1", 14336),
                                      ("yi-6b", 11008)])
def test_gemv_down_key_at_16_rows(name, hid):
    assert shape(name).hidden == hid
    l = work.Launch.parse(f"int4_matmul_fused/gemv/silu+residual+ss/m16/"
                          f"{hid}x4096")
    hand = (hid * 4096 // 2 + 4096 * (hid // 128) * 3
            + 16 * hid * 2 * 2        # gate and up, once each
            + 16 * 4096 * 2           # residual
            + 16 * 4096 * 2 + 16 * 4)  # out and its rms scale
    assert work.w4_bytes(l) == hand


@pytest.mark.parametrize("name", ["mistral-7b-v0.1", "yi-6b"])
def test_gemm_gate_up_key(name):
    s = shape(name)
    n_out = 2 * s.hidden
    l = work.Launch.parse(f"int4_matmul_fused/gemm/prescale/m128/4096x{n_out}")
    assert l.kernel == "gemm"
    assert work.w4_ops(l, 100) == 2 * 100 * 4096 * n_out
    t = work.least_seconds(work.w4_ops(l), work.w4_bytes(l))
    assert t == pytest.approx(2 * 128 * 4096 * n_out / 989e12)


def test_unfused_and_dtype_suffix_keys():
    l = work.Launch.parse("int4_matmul/gemv/m8/4096x4096")
    assert (l.out, l.flags) == ("f32", ())
    l = work.Launch.parse("int4_matmul_fused/gemv/residual+ss/m1/4096x4096"
                          "/out_f16/res_f32")
    assert (l.out, l.res) == ("f16", "f32")
    assert work.Launch.parse("dense_gemv/bf16/m1/32000x4096") is None


@pytest.mark.parametrize("name,token_gb", [("mistral-7b-v0.1", 3.92),
                                           ("yi-6b", 3.42)])
def test_a_decode_token_reads(name, token_gb):
    s = shape(name)
    total = work.layer_weight_bytes(s) + work.head_bytes(s)
    assert total / 1e9 == pytest.approx(token_gb, abs=0.01)


def test_passes_from_counters():
    s = shape("yi-6b")
    launches = {"int4_matmul_fused/gemv/prescale/m8/4096x5120": 320,
                "int4_matmul_fused/gemv/prescale/m8/4096x22016": 320,
                "int4_matmul_fused/gemm/prescale/m128/4096x5120": 64,
                "int4_matmul_fused/gemv/prescale/m1/4096x5120": 32,
                "dense_gemv/bf16/m8/64000x4096": 10}
    assert work.passes(launches, s) == {8: 10, 128: 2, 1: 1}
    assert work.head_launches(launches, s) == 10


def test_row_counts():
    s = shape("mistral-7b-v0.1")
    p = 99
    assert work.row_ops(s, p, head=True) == (
        2 * 32 * work.layer_params(s) + 4 * 32 * 32 * 128 * 100
        + 2 * 32000 * 4096)
    assert work.row_bytes(s, p) == 4096 * 2 + 32 * 2 * 1024 * 2 * 101
