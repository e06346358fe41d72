"""The port's data-parallel x tensor-parallel run on the CPU, held to the
JAX package's.

The batch-sharded forward (parallel/tp.py, given a Mesh) runs on 4
gloo ranks as make_mesh(tp=2, dp=2), in one spawn of
tests/torch_tp_ranks.py's rank jobs; its oracle is the JAX
make_tp_forward(..., batch_sharded=True) on 4 of the conftest's 8 virtual
CPU devices, bound as tests/test_torch_tp.py binds the JAX TP forward
(fused=True, matmul_impl="dequant", the Pallas wrapper's bf16 staging,
`.bin` scales that bf16 holds exactly), at tests/test_tp.py:69's bar,
rtol=atol=2e-2. tools/multihost_worker.py's port runs as two host
processes of two ranks each, held to the JAX worker's single-process
oracle at tests/test_multihost.py's bar, and bench_scaling --nprocs 2
runs its TP widths as two processes.
"""

import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.io.checkpoint import random_checkpoint as t_random
from llama_cu_awq_torch.io.checkpoint import save_checkpoint as t_save
from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_torch.parallel import (Mesh, TPGroup, all_gather_batch,
                                         local_rows)
from llama_cu_awq_torch.parallel import tp as ttp
from llama_cu_awq_torch.parallel.mesh import split_at_collectives
from llama_cu_awq_torch.parallel.multihost import world_cards
from llama_cu_awq_torch.tools import multihost_worker as worker
from llama_cu_awq_tpu.io.checkpoint import load_checkpoint as j_load
from llama_cu_awq_tpu.parallel import make_mesh as j_make_mesh
from llama_cu_awq_tpu.parallel import tp as jtp
from llama_cu_awq_tpu.parallel.tp import place_params
from tests.test_torch_tp import jax_kernel_path  # noqa: F401 (autouse)
from tests.test_torch_tp import TP_CFG, _bf16_scales, _jax_shard_forward

import torch_tp_ranks as ranks  # noqa: E402  isort: skip

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
DP, TP, B = 2, 2, 4
# the global batch's tokens by step, and each slot's first position
TOKENS = np.random.default_rng(99).integers(4, 500, size=(4, B)).tolist()
OFFSETS = [0, 2, 1, 3]
CACHES = ["plain", "int8"]


def _dp_job(cache):
    return dict(kind="dp_forward", name=f"dp_{cache}", act="float32",
                cache=cache, max_seq=32, tokens=TOKENS, offsets=OFFSETS,
                tp=TP, dp=DP)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The dp x tp jobs on 4 gloo ranks (every rank's results), and the
    `.bin` they read (tests/test_torch_tp.py's TP_CFG, seed 78)."""
    tmp = tmp_path_factory.mktemp("dp_tp")
    path = str(tmp / "tp.bin")
    t_save(path, _bf16_scales(t_random(TP_CFG, seed=78)))
    jobs = [_dp_job(c) for c in CACHES] + [dict(kind="dp_gather",
                                                name="dp_gather")]
    return ranks.spawn_ranks(4, tmp, path, jobs), path


def _jax_dp_run(path, cache_kind):
    """The JAX batch-sharded TP forward's logits by step (steps, B, V)
    and its last cache."""
    ckpt = j_load(path)
    cfg = ckpt.config
    mesh = j_make_mesh(tp=TP, dp=DP, devices=jax.devices()[:DP * TP])
    params = place_params(jtp.tp_params_from_checkpoint(
        ckpt, TP, param_dtype=jnp.float32), cfg, mesh)
    cache = jtp.tp_init_kv_cache(cfg, B, 32, mesh, dtype=jnp.float32,
                                 batch_sharded=True,
                                 quantized=cache_kind == "int8")
    fwd = _jax_shard_forward(cfg, mesh, batch_sharded=True)
    rows = []
    for i, step in enumerate(TOKENS):
        lg, cache = fwd(params, jnp.asarray(step, jnp.int32)[:, None],
                        jnp.asarray(OFFSETS, jnp.int32) + i, cache,
                        attn_len=32, act_dtype=jnp.float32)
        rows.append(np.asarray(lg, np.float32))
    return np.stack(rows), cache


def _slots(res):
    """A rank's slots of the global batch (its dp row's)."""
    b = B // DP
    return slice(res["dp_index"] * b, (res["dp_index"] + 1) * b)


@pytest.mark.parametrize("cache", CACHES)
def test_dp_tp_forward_matches_jax(dp_runs, cache):
    """Each rank's logits over 4 steps (the cache carried) are its dp
    row's rows of the JAX batch-sharded forward's; the last step gathered
    over dp is the JAX global logits, on every rank."""
    res, path = dp_runs
    want, _ = _jax_dp_run(path, cache)
    got_all = res[f"dp_{cache}"]
    assert sorted((r["dp_index"], r["tp_rank"]) for r in got_all) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in got_all:
        assert r["logits"].shape == (len(TOKENS), B // DP,
                                     TP_CFG.vocab_size)
        assert np.isfinite(r["logits"]).all()
        np.testing.assert_allclose(r["logits"], want[:, _slots(r)],
                                   rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(r["gathered"], want[-1], rtol=2e-2,
                                   atol=2e-2)
        # the gather is the rows themselves, in dp order
        mine = [o["logits"][-1] for o in sorted(
            (o for o in got_all if o["tp_rank"] == r["tp_rank"]),
            key=lambda o: o["dp_index"])]
        np.testing.assert_array_equal(r["gathered"], np.concatenate(mine))


@pytest.mark.parametrize("cache", CACHES)
def test_dp_tp_caches_match_jax(dp_runs, cache):
    """Rank (row r, column c) holds the (slots of row r, kv heads of
    column c) block of the JAX cache after the 4 steps (the int8 codes
    compared with their scales applied)."""
    res, path = dp_runs
    _, jcache = _jax_dp_run(path, cache)
    kv = TP_CFG.n_kv_heads // TP
    for r in res[f"dp_{cache}"]:
        c, sl = r["tp_rank"], _slots(r)
        for name in ("k", "v"):
            for layer in range(TP_CFG.n_layers):
                want = np.asarray(getattr(jcache, name)[layer], np.float32)
                got = r["cache"][name][layer]
                if cache == "int8":
                    want = want * np.asarray(
                        getattr(jcache, f"{name}_scale")[layer])[..., None]
                    got = got * r["cache"][f"{name}_scale"][layer][..., None]
                want = want[sl, :, c * kv:(c + 1) * kv]
                assert got.shape == want.shape == (B // DP, 32, kv,
                                                   TP_CFG.head_dim)
                np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_dp_gather_returns_rows_in_dp_order(dp_runs):
    """all_gather_batch gives its column's rows in dp_index order: each
    rank's rows are its own, so a swapped order would not pass."""
    got = dp_runs[0]["dp_gather"]
    for r in got:
        col = sorted((o for o in got if o["tp_rank"] == r["tp_rank"]),
                     key=lambda o: o["dp_index"])
        np.testing.assert_array_equal(
            r["gathered"], np.concatenate([o["x"] for o in col]))
        assert not np.array_equal(col[0]["x"], col[1]["x"])


def _mesh(dp_index=0):
    """A (2, 2) Mesh seen from one rank, with no process group."""
    group = TPGroup(0, TP, None, "gloo", torch.device("cpu"), (0, 1))
    return Mesh(np.arange(4).reshape(DP, TP), group, object(), dp_index)


def test_batch_sharding_needs_whole_rows():
    """A batch that dp does not divide raises ValueError, in the cache,
    in the forward and in local_rows; a rank's rows are its dp row's; a
    TPGroup's cache keeps every slot."""
    mesh = _mesh(dp_index=1)
    with pytest.raises(ValueError, match="does not split over dp=2"):
        ttp.tp_init_kv_cache(TP_CFG, 3, 32, mesh, device="cpu")
    with pytest.raises(ValueError, match="does not split over dp=2"):
        local_rows(torch.zeros(5, 1), mesh)
    params = ttp.shard_params(tl.params_from_checkpoint(
        t_random(TP_CFG, seed=1), device="cpu"), TP_CFG, TP, 0)
    cache = ttp.tp_init_kv_cache(TP_CFG, 4, 32, mesh, device="cpu")
    assert cache.k[0].shape == (2, 32, TP_CFG.n_kv_heads // TP,
                                TP_CFG.head_dim)
    fwd = ttp.make_tp_forward(TP_CFG, mesh, attn_len=32)
    with pytest.raises(ValueError, match="does not split over dp=2"):
        fwd(params, torch.ones(3, 1, dtype=torch.int64),
            torch.zeros(3, dtype=torch.int32), cache)
    assert local_rows(np.arange(8), mesh).tolist() == [4, 5, 6, 7]
    assert ttp.tp_init_kv_cache(TP_CFG, 3, 32, TP,
                                device="cpu").k[0].shape[0] == 3


def test_dp_gather_refuses_a_captured_step():
    """The dp gather is the caller's, after a step: inside a split
    capture it raises rather than hand itself to the capture."""
    with split_at_collectives(lambda run: None):
        with pytest.raises(RuntimeError, match="captured step"):
            all_gather_batch(torch.zeros(2, 3), _mesh())


@pytest.mark.parametrize("cards, sharing, want", [
    (2, 2, [("gloo", 0), ("gloo", 0)]),   # 4 ranks on one machine of 2
    (4, 2, [("nccl", 0), ("nccl", 2)]),   # a card each, its own cards
    (2, 1, [("nccl", 0), ("nccl", 0)]),   # two hosts of 2 cards
    (1, 1, [("gloo", 0), ("gloo", 0)]),   # two hosts of 1 card
])
def test_world_cards_never_puts_two_nccl_ranks_on_a_card(monkeypatch, cards,
                                                        sharing, want):
    """One world of 2 processes x 2 ranks: nccl only where each of a
    machine's ranks has a card of its own, the processes sharing a
    machine on distinct cards; else gloo on card 0. The CPU is gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert [world_cards("cuda", pid, 2, sharing)
            for pid in range(2)] == want
    assert world_cards("cpu", 1, 2, sharing) == ("gloo", 0)


# ---------------------------------------------------------------------------
# tools/multihost_worker.py and bench_scaling --nprocs as processes

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _processes(module, per_pid, timeout=300):
    """`python -m module` twice, --pid 0 and 1, at once, each in a
    session of its own (its spawned ranks are its children), its output
    to files so no pipe fills: (code, stdout, stderr) each. A process
    that fails or outlives the timeout stops the wait, and every process
    group still running then is killed."""
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
             for _ in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *per_pid(pid)], cwd=REPO, env=ENV,
        stdout=out, stderr=err, text=True, start_new_session=True)
        for pid, (out, err) in enumerate(files)]
    deadline = time.time() + timeout
    try:
        while (any(p.poll() is None for p in procs)
               and not any(p.returncode for p in procs)
               and time.time() < deadline):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    outs = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        outs.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return outs


def _checksum(out: str) -> float:
    lines = [ln for ln in out.splitlines() if ln.startswith("CHECKSUM ")]
    assert len(lines) == 1 and "MULTIHOST OK" in out, out
    return float(lines[0].split()[1])


@pytest.fixture(scope="module")
def jax_single():
    """The JAX worker's single-process oracle (tools/multihost_worker.py
    run_single, loaded by path), 4 steps of batch 4."""
    spec = importlib.util.spec_from_file_location(
        "jax_multihost_worker", os.path.join(REPO, "tools",
                                             "multihost_worker.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run_single(4, 4)


def test_worker_hosts_match_jax_single(jax_single):
    """Two `--role worker --tp 2 --device cpu` processes (4 ranks, dp 2 x
    tp 2): both print MULTIHOST OK and the same checksum, within
    tests/test_multihost.py's bar of the JAX single-process run."""
    port = _free_port()
    outs = _processes("llama_cu_awq_torch.tools.multihost_worker",
                      lambda pid: ["--role", "worker", "--nprocs", "2",
                                   "--pid", str(pid), "--port", str(port),
                                   "--tp", "2", "--device", "cpu",
                                   "--steps", "4", "--batch", "4"])
    sums = []
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        sums.append(_checksum(out))
    assert sums[0] == pytest.approx(sums[1], abs=1e-3)
    for got in sums:
        assert abs(got - jax_single) <= max(0.05 * abs(jax_single), 2.0)


def test_worker_single_matches_jax_single(jax_single):
    """The port's --role single (its single-device forward on the same
    weights and inputs) against the JAX worker's run_single."""
    args = types.SimpleNamespace(device="cpu", config="tiny", batch=4,
                                 steps=4)
    assert worker.run_single(args) == pytest.approx(jax_single, rel=2e-2,
                                                    abs=2e-2)


def test_bench_scaling_tp_widths_in_two_processes():
    """bench_scaling --smoke --nprocs 2 as two processes: each runs its
    own replica at tp 1 and tp 2 (two ranks of its own), through the
    bench's batch mode and its replay gate, and prints its point lines
    and its efficiency line."""
    port = _free_port()
    outs = _processes("llama_cu_awq_torch.tools.bench_scaling",
                      lambda pid: ["--smoke", "--nprocs", "2", "--pid",
                                   str(pid), "--coordinator",
                                   f"127.0.0.1:{port}"])
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-3000:]
        lines = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith("{")]
        assert [ln["metric"] for ln in lines] == [
            f"scaling_tok_s_tiny_tp1_proc{pid}",
            f"scaling_tok_s_tiny_tp2_proc{pid}",
            "scaling_efficiency_tiny_tp2"]
        assert [ln["devices"] for ln in lines[:2]] == [2, 4]
        assert all(np.isfinite(ln["value"]) and ln["value"] > 0
                   for ln in lines)
        assert err.count("batch gate:") == 2
