"""The trace reader on a stored Chrome trace whose kernel names are the
ones torch.profiler recorded on the H100 (data/trace_small.json):
one window of 1000 us, the w4 GEMV and GEMM families with their rms
epilogues, the head, a copy and kernels cut by the window's edges."""

import os

import pytest

from perfbench import work
from perfbench.trace import Trace, family

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "trace_small.json")


@pytest.fixture(scope="module")
def tr():
    return Trace.load(DATA)


def test_window_and_busy_union(tr):
    assert tr.window_s == pytest.approx(1000e-6)
    # 1000-1060, 1200-1430, 1500-1650, 1700-1850, 1950-2000
    assert tr.busy_intervals() == [(1000.0, 1060.0), (1200.0, 1430.0),
                                   (1500.0, 1650.0), (1700.0, 1850.0),
                                   (1950.0, 2000.0)]
    assert tr.busy_s() == pytest.approx(640e-6)


@pytest.mark.parametrize("name,fam", [
    ("int4_gemv", (50 + 10 + 100 + 50) * 1e-6),
    ("int4_gemm", (20 + 180 + 20 + 10) * 1e-6)])
def test_family_seconds_take_their_epilogues(tr, name, fam):
    f = work.load_family(name)
    secs, _ = tr.family_seconds(f["kernels"], f["epilogue"], f["owners"])
    assert secs == pytest.approx(fam)


def test_families_and_names():
    assert family("void (anonymous namespace)::int4_gemv_kernel<1, "
                  "__nv_bfloat16>(__nv_bfloat16 const*, int)") == \
        "(anonymous namespace)::int4_gemv_kernel"
    assert family("(anonymous namespace)::int4_gemm_kernel(CUtensorMap_st, "
                  "int)") == "(anonymous namespace)::int4_gemm_kernel"
    assert family("gemmSN_NN_kernel") == "gemmSN_NN_kernel"


def test_breakdown(tr):
    ops = dict(tr.device_ops())
    assert ops["(anonymous namespace)::int4_gemv_kernel"] == \
        pytest.approx(200e-6)
    assert len(tr.device_ops()) <= 10
    gaps = dict(tr.idle_gaps())
    # 1060-1200 under cudaGraphLaunch, 1850-1950 under aten::copy_, and
    # 1430-1500 and 1650-1700 under no host event
    assert gaps["cudaGraphLaunch"] == pytest.approx(140e-6)
    assert gaps["aten::copy_"] == pytest.approx(100e-6)
    assert gaps["no host event"] == pytest.approx(120e-6)
    assert sum(gaps.values()) == pytest.approx(360e-6)


@pytest.mark.parametrize("name", ["int4_gemv", "int4_gemm"])
def test_families_are_the_names_the_card_recorded(name):
    f = work.load_family(name)
    seen = {family(n) for n in f["seen_on_card"]["names"]}
    assert seen == set(f["kernels"]) | set(f["epilogue"])
