"""The port's tensor parallelism on the CPU, held to the JAX package's.

The port runs one process per shard: tests/torch_tp_ranks.py spawns gloo
ranks, which load the same `.bin` the JAX side loads and build their own
shards. The oracle is the JAX TP forward on its 8-device virtual CPU mesh
(tests/conftest.py): JAX forward(..., fused=True, matmul_impl="dequant",
tp_axis="tp") under jax.shard_map, jitted, over the JAX
tp_params_from_checkpoint of that `.bin` (make_shard_forward's wrapper with
fused=True, written out here; the JAX package is not changed), its
qmatmul_fused given the Pallas wrapper's casts of x and u to bf16 as
tests/test_torch_act_dtype.py gives them (`_staged`: the kernel path's
numerics, which the port follows; the CPU composite alone rounds
x * ss * norm_w from f32 once), at tests/test_tp.py:69's bar,
rtol=atol=2e-2. The JAX TP layout holds its
scales in bf16 (its planar metadata) where the port holds the file's
fp16, so the `.bin` files here carry scales that bf16 holds exactly
(_bf16_scales): both packages then hold the same weights, and the
comparison sees the sharding alone, as tests/test_torch_act_dtype.py
rounds its scales for the JAX kernels' bf16 metadata. (With the file's
own scales the 2^-8 rounding of a scale moves logits past 2e-2 at dim
2048, and through the int4 cache's 15 levels at dim 512.)

Against the port's own single-device forward in f32: with the w4
matmuls' x kept in f32 (torch_tp_ranks.exact_staging) the two differ by
the order of their f32 sums alone, held at rtol=1e-4, atol=1e-5; with the
kernels' bf16 staging of x, a sum one f32 ulp apart can round an element
of x one bf16 ulp apart and move a whole row of logits by about 2e-3
(measured on these configs), so that run is held at tests/test_tp.py:77's
bar for the same comparison, rtol=atol=5e-3.
"""

import functools
import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from llama_cu_awq_torch.cli import main as t_main
from llama_cu_awq_torch.config import LLAMA2_7B, LLAMA2_13B
from llama_cu_awq_torch.config import ModelConfig as TModelConfig
from llama_cu_awq_torch.engine import BatchEngine, InferenceEngine
from llama_cu_awq_torch.io.checkpoint import load_checkpoint as t_load
from llama_cu_awq_torch.io.checkpoint import random_checkpoint as t_random
from llama_cu_awq_torch.io.checkpoint import save_checkpoint as t_save
from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_torch.parallel import (TPGroup, init_multihost,
                                         is_coordinator, make_mesh,
                                         pod_mesh)
from llama_cu_awq_torch.parallel import tp as ttp
from llama_cu_awq_tpu.engine.engine import InferenceEngine as JEngine
from llama_cu_awq_tpu.io.checkpoint import load_checkpoint as j_load
from llama_cu_awq_tpu.models import llama as jl
from llama_cu_awq_tpu.parallel import make_mesh as j_make_mesh
from llama_cu_awq_tpu.parallel import tp as jtp
from llama_cu_awq_tpu.parallel.tp import place_params
from tests.test_torch_act_dtype import _staged
from tests.test_tokenizer import write_toy_tokenizer
from tests.test_torch_engine import _toy_vocab

# tests/ is on sys.path (pytest's rootdir-less test directory): the
# spawned ranks import the helper by this name
import torch_tp_ranks as ranks  # noqa: E402  isort: skip
from torch_graph_standins import check_split_job  # noqa: E402  isort: skip

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
torch.set_num_threads(1)

# tests/test_tp.py:21-28's tp_config: kv_dim / tp a multiple of 128 up to
# tp 4, and whole 128-row groups in every row shard
TP_CFG = TModelConfig(dim=512, hidden_dim=1024, n_layers=2, n_heads=4,
                      n_kv_heads=4, vocab_size=512, seq_len=128)
# test_tp_prefill_kernel_parity's: 8 local heads of 128 at tp 2
PFK_CFG = TModelConfig(dim=2048, hidden_dim=512, n_layers=1, n_heads=16,
                       n_kv_heads=16, vocab_size=256, seq_len=128)
TOKENS = [3, 141, 59, 26, 500]
PFK_TOKENS = [(3 + 7 * i) % PFK_CFG.vocab_size for i in range(64)]

# name -> (tps, job): T=1 steps and a T=5 block over the f32, bf16, int8
# and int4 caches, fused_step after a 3-token prompt at a 128-row cache
# (test_tp_fused_step_parity's setting), and the prefill kernel on a
# 64-token block (test_tp_prefill_kernel_parity's); attn_impl is given
# on both sides
FORWARD_CASES = {
    "t1_f32": ((2, 4), dict(mode="steps")),
    "t5_f32": ((2,), dict(mode="block")),
    "t5_bf16": ((2,), dict(mode="block", act="bfloat16")),
    "t1_int8": ((2,), dict(mode="steps", cache="int8")),
    "t5_int8": ((4,), dict(mode="block", cache="int8")),
    "t5_int4": ((2,), dict(mode="block", cache="int4")),
    "fused_step_f32": ((2,), dict(mode="prompt_step", max_seq=128,
                                  tokens=[5, 9, 300, 42],
                                  attn_impl="fused_step")),
    "fused_step_int8": ((2,), dict(mode="prompt_step", max_seq=128,
                                   cache="int8", tokens=[5, 9, 300, 42],
                                   attn_impl="fused_step")),
    "prefill_kernel": ((2,), dict(mode="block", bin="pfk", max_seq=128,
                                  tokens=PFK_TOKENS,
                                  attn_impl="fused_step")),
}
CASE_IDS = [(name, tp) for name, (tps, _) in FORWARD_CASES.items()
            for tp in tps]
# the engine, CLI and server cases' model
ENGINE_CFG = TModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=2,
                          n_kv_heads=2, vocab_size=512, seq_len=256)
ENGINE_PROMPT = [1, 7, 42, 3, 200, 99, 5, 17]
BATCH_PROMPTS = [[1, 5, 9, 11], [1] + [(3 * i) % 500 + 4 for i in range(140)],
                 [1, 300, 2, 77, 8, 8, 8]]


def _bf16_scales(ckpt):
    """ckpt with every w4 scale rounded to bf16, which fp16 then holds
    exactly (the JAX TP layout's scales equal the port's)."""
    for layer in ckpt.layers:
        for q in (layer.wq, layer.wk, layer.wv, layer.wo, layer.w_gate,
                  layer.w_up, layer.w_down):
            s = torch.from_numpy(np.asarray(q.scales, np.float32))
            q.scales = s.bfloat16().float().numpy()
            assert np.array_equal(q.scales.astype(np.float16), q.scales)
    return ckpt


def _job(name, **over):
    tps, job = FORWARD_CASES[name]
    job = {**dict(act="float32", cache="plain", max_seq=32, tokens=TOKENS,
                  kind="forward"), **job, **over}
    return dict(job, name=name + ("_exact" if job.get("exact") else ""))


def _jobs(tp, paths):
    out = []
    for name, (tps, job) in FORWARD_CASES.items():
        if tp not in tps:
            continue
        b = paths[job.get("bin", "tp")]
        out.append(_job(name, bin=b))
        if job.get("act", "float32") == "float32":
            out.append(_job(name, bin=b, exact=True))
    if tp == 2:
        out.append(dict(kind="engine", name="engine", bin=paths["engine"],
                        act="float32", max_seq=64, prompt=ENGINE_PROMPT,
                        steps=24))
        out.append(dict(kind="batch", name="batch", bin=paths["engine"],
                        prompts=BATCH_PROMPTS, max_new=8, rounds=2,
                        kw=dict(n_slots=2, max_seq=256, chunk_size=4,
                                temperature=0.0, spec=None,
                                prefix_cache_size=2)))
        out.append(dict(kind="batch", name="batch_spec",
                        bin=paths["engine"], prompts=BATCH_PROMPTS[::2],
                        max_new=8,
                        kw=dict(n_slots=2, max_seq=256, chunk_size=4,
                                temperature=0.0, spec="ngram", spec_k=4)))
        # the same engines made with capture=True, their bodies replayed
        # stale (torch_graph_standins._StaleSet), and the split capture
        out += [dict(j, name=j["name"] + "_stale", stale=True)
                for j in out if j["kind"] in ("engine", "batch")]
        out.append(dict(kind="split", name="split"))
    else:
        out.append(dict(kind="mesh", name="mesh", tp=2, dp=2))
    return out


@pytest.fixture(scope="module", autouse=True)
def jax_kernel_path():
    """The JAX forward on the kernel path's numerics (see the module
    docstring), for every JAX run of this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jl, "qmatmul_fused", _staged(jl.qmatmul_fused))
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank job, one spawn a tp degree: {tp: results}, and the
    `.bin` paths."""
    tmp = tmp_path_factory.mktemp("tp")
    paths = {}
    for key, cfg, seed in (("tp", TP_CFG, 78), ("pfk", PFK_CFG, 13),
                           ("engine", ENGINE_CFG, 5)):
        paths[key] = str(tmp / f"{key}.bin")
        t_save(paths[key], _bf16_scales(t_random(cfg, seed=seed)))
    res = {tp: ranks.spawn_ranks(tp, tmp, paths["tp"], _jobs(tp, paths))
           for tp in (2, 4)}
    return res, paths


# ---------------------------------------------------------------------------
# the JAX oracle

def _jax_shard_forward(cfg, mesh, batch_sharded=False):
    """make_shard_forward (llama_cu_awq_tpu/parallel/tp.py) with
    fused=True and matmul_impl="dequant", jitted; batch_sharded as the
    JAX function's (the batch over "dp")."""
    tp = mesh.shape["tp"]
    b = "dp" if batch_sharded else None
    params_spec = jax.tree.map(
        lambda s: s.spec, jtp.tp_param_shardings(cfg, mesh),
        is_leaf=lambda x: isinstance(x, NamedSharding))
    n = cfg.n_layers
    kv_spec, kvs_spec = P(b, None, "tp", None), P(b, None, "tp")

    @functools.partial(jax.jit, static_argnames=(
        "attn_len", "act_dtype", "matmul_impl", "attn_impl", "logits_all",
        "no_logits"))
    def fwd(params, tokens, pos, cache, *, attn_len=None,
            act_dtype=jnp.bfloat16, matmul_impl=None, attn_impl=None,
            logits_all=False, no_logits=False):
        specs = (jl.KVCache([kv_spec] * n, [kv_spec] * n, [kvs_spec] * n,
                            [kvs_spec] * n) if cache.quantized
                 else jl.KVCache([kv_spec] * n, [kv_spec] * n))
        logits_spec = (None if no_logits else P(b, None, None)
                       if logits_all else P(b, None))

        def local(params, tokens, pos, cache):
            return jl.forward(params, cfg, tokens, pos, cache,
                              attn_len=attn_len, act_dtype=act_dtype,
                              matmul_impl="dequant", attn_impl=attn_impl,
                              logits_all=logits_all, no_logits=no_logits,
                              tp_axis="tp", tp_size=tp, fused=True)

        return jax.shard_map(
            local, mesh=mesh, in_specs=(params_spec, P(b, None), P(b),
                                        specs),
            out_specs=(logits_spec, specs), check_vma=False)(
                params, tokens, pos, cache)

    return fwd


@functools.lru_cache(maxsize=None)
def _jax_setup(path, tp, act):
    ckpt = j_load(path)
    cfg = ckpt.config
    mesh = j_make_mesh(tp=tp, dp=1, devices=jax.devices()[:tp])
    params = place_params(jtp.tp_params_from_checkpoint(
        ckpt, tp, param_dtype=getattr(jnp, act)), cfg, mesh)
    return cfg, mesh, params, _jax_shard_forward(cfg, mesh)


def _jax_logits(job, tp, calls):
    cfg, mesh, params, fwd = _jax_setup(job["bin"], tp, job["act"])
    act = getattr(jnp, job["act"])
    q = job["cache"] != "plain"
    cache = jtp.tp_init_kv_cache(cfg, 1, job["max_seq"], mesh, dtype=act,
                                 quantized=q,
                                 kv_bits=4 if job["cache"] == "int4" else 8)
    kw = dict(attn_len=job["max_seq"], act_dtype=act,
              attn_impl=job.get("attn_impl"))
    toks = job["tokens"]
    from llama_cu_awq_tpu.ops.pallas import prefill_attention as pf

    real = pf.prefill_attention

    def counted(*a, **k):  # counted as the jit traces it
        calls["prefill_attention"] = calls.get("prefill_attention", 0) + 1
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pf, "prefill_attention", counted)
        if job["mode"] == "steps":
            rows = []
            for i, t in enumerate(toks):
                lg, cache = fwd(params, jnp.asarray([[t]]),
                                jnp.asarray([i], jnp.int32), cache, **kw)
                rows.append(np.asarray(lg[0]))
            return np.stack(rows)
        if job["mode"] == "block":
            lg, _ = fwd(params, jnp.asarray([toks]), jnp.zeros(1, jnp.int32),
                        cache, logits_all=True, **kw)
            return np.asarray(lg[0])
        _, cache = fwd(params, jnp.asarray([toks[:-1]]),
                       jnp.zeros(1, jnp.int32), cache, no_logits=True,
                       attn_len=job["max_seq"], act_dtype=act)
        lg, _ = fwd(params, jnp.asarray([toks[-1:]]),
                    jnp.asarray([len(toks) - 1], jnp.int32), cache, **kw)
        return np.asarray(lg)


# ---------------------------------------------------------------------------
# forward

@pytest.mark.parametrize("name,tp", CASE_IDS,
                         ids=[f"{n}-tp{t}" for n, t in CASE_IDS])
def test_tp_forward_matches_jax(runs, name, tp):
    res, paths = runs
    job = _job(name, bin=paths[FORWARD_CASES[name][1].get("bin", "tp")])
    got, calls = res[tp][name]
    jcalls = {}
    want = _jax_logits(job, tp, jcalls)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    if name == "prefill_kernel":
        # both packages took their prefill kernel (one call a layer)
        assert calls.get("prefill_attention") == 1
        assert jcalls.get("prefill_attention", 0) >= 1
    if name.startswith("fused_step"):
        assert calls.get("attention_step") == TP_CFG.n_layers


@pytest.mark.parametrize("name,tp", CASE_IDS,
                         ids=[f"{n}-tp{t}" for n, t in CASE_IDS])
def test_tp_forward_matches_single_device(runs, name, tp):
    res, paths = runs
    job = _job(name, bin=paths[FORWARD_CASES[name][1].get("bin", "tp")])
    ckpt = t_load(job["bin"])
    got, _ = res[tp][name]
    want, _ = ranks.forward_job(job, ckpt)
    if job["act"] != "float32":
        # bf16 activations: the sum's rms is taken before the cast under
        # tp, after it on one device (models/llama.py _after_sum)
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
        return
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    exact, _ = res[tp][name + "_exact"]
    with ranks.exact_staging():
        want_exact, _ = ranks.forward_job(job, ckpt)
    np.testing.assert_allclose(exact, want_exact, rtol=1e-4, atol=1e-5)


def test_plan_holds_the_local_heads():
    """plan() under tp: the rank's heads decide the kernels, and the plan
    records tp, so no graph key mixes a TP plan with a single-device one;
    the down_qkv chain is off."""
    params = ttp.shard_params(tl.params_from_checkpoint(
        t_random(TP_CFG, seed=1), device="cpu"), TP_CFG, 2, 0)
    cache = ttp.tp_init_kv_cache(TP_CFG, 1, 1024, 2, device="cpu")
    assert cache.k[0].shape == (1, 1024, 2, 128)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLAMA_TPU_DOWN_QKV", "1")
        p2 = tl.plan(params, TP_CFG, cache, 1, 1, 1024, "auto", 2)
        p1 = tl.plan(params, TP_CFG, cache, 1, 1, 1024, "auto", 1)
    assert p2.fstep and p2.tp == 2 and not p2.dq_chain and p2 != p1
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLAMA_TPU_FSTEP_TP", "0")
        mp.setenv("LLAMA_TPU_PFK_TP", "0")
        assert not tl.plan(params, TP_CFG, cache, 1, 1, 1024, "auto",
                           2).fstep
        assert not tl.plan(params, TP_CFG, cache, 1, 128, 1024, "auto",
                           2).pfk


# ---------------------------------------------------------------------------
# the shard functions and the divisibility rule

@pytest.mark.parametrize("tp", [2, 4])
def test_shard_functions_slice_the_full_weights(tp):
    """Each rank's dequantized shard equals the matching slice of the
    full dequantized weight; shard_params of full params builds the same
    tensors as tp_params_from_checkpoint; the shards join back up."""
    ckpt = t_random(TP_CFG, seed=4)
    full = tl.params_from_checkpoint(ckpt, device="cpu")
    dim, kv, hid = TP_CFG.dim, TP_CFG.kv_dim, TP_CFG.hidden_dim
    shards = [ttp.tp_params_from_checkpoint(ckpt, tp, r, device="cpu")
              for r in range(tp)]
    for r, sh in enumerate(shards):
        q, k, h = dim // tp, kv // tp, hid // tp
        for lf, ls in zip(full.layers, sh.layers):
            w = lf.wqkv.dequantize()
            want = torch.cat([w[:, r * q:(r + 1) * q],
                              w[:, dim + r * k:dim + (r + 1) * k],
                              w[:, dim + kv + r * k:dim + kv + (r + 1) * k]],
                             dim=1)
            assert torch.equal(ls.wqkv.dequantize(), want)
            w = lf.w_gate_up.dequantize()
            want = torch.cat([w[:, r * h:(r + 1) * h],
                              w[:, hid + r * h:hid + (r + 1) * h]], dim=1)
            assert torch.equal(ls.w_gate_up.dequantize(), want)
            assert torch.equal(ls.wo.dequantize(),
                               lf.wo.dequantize()[r * q:(r + 1) * q])
            assert torch.equal(ls.w_down.dequantize(),
                               lf.w_down.dequantize()[r * h:(r + 1) * h])
        v = TP_CFG.vocab_size // tp
        assert torch.equal(sh.lm_head, full.lm_head[v * r:v * (r + 1)])
        assert torch.equal(sh.embed, full.embed)
        other = ttp.shard_params(full, TP_CFG, tp, r)
        for a, b in zip(other.layers, sh.layers):
            for name in ("wqkv", "wo", "w_gate_up", "w_down"):
                qa, qb = getattr(a, name), getattr(b, name)
                assert (qa.n_in, qa.n_out) == (qb.n_in, qb.n_out)
                for f in ("qw", "scales", "zeros"):
                    assert torch.equal(getattr(qa, f), getattr(qb, f))
    # the row shards of a projection add up to the whole product
    x = torch.randn(3, dim)
    got = sum(tl.qmatmul(x[:, r * (dim // tp):(r + 1) * (dim // tp)],
                         s.layers[0].wo) for r, s in enumerate(shards))
    np.testing.assert_allclose(got, tl.qmatmul(x, full.layers[0].wo),
                               rtol=1e-4, atol=1e-5)


def test_tp_synthetic_params_are_shards_of_synthetic_params():
    full = tl.synthetic_params(TP_CFG, seed=3, device="cpu")
    sh = ttp.tp_synthetic_params(TP_CFG, 2, 1, seed=3, device="cpu")
    want = ttp.shard_params(full, TP_CFG, 2, 1)
    assert torch.equal(sh.lm_head, want.lm_head)
    for a, b in zip(sh.layers, want.layers):
        assert torch.equal(a.wqkv.qw, b.wqkv.qw)
        assert torch.equal(a.w_down.scales, b.w_down.scales)


def test_row_shard_that_splits_a_group_raises():
    """A row shard of wo or w_down must hold whole 128-row groups: the
    JAX _row_shard takes the wrong groups there (ROADMAP.md, known
    defects in the reference); the port refuses, naming the width."""
    cfg = TModelConfig(dim=512, hidden_dim=1280, n_layers=1, n_heads=4,
                       n_kv_heads=4, vocab_size=512, seq_len=64)
    with pytest.raises(ValueError, match="1280 // 4 = 320"):
        ttp._check_divisible(cfg, 4)
    with pytest.raises(ValueError, match="320"):
        ttp.tp_params_from_checkpoint(t_random(cfg, seed=1), 4, 0,
                                      device="cpu")
    with pytest.raises(ValueError, match="11008 // 4 = 2752"):
        ttp._check_divisible(LLAMA2_7B, 4)
    ttp._check_divisible(LLAMA2_7B, 2)    # 5504 = 43 groups
    ttp._check_divisible(LLAMA2_13B, 2)   # 6912
    ttp._check_divisible(LLAMA2_13B, 4)   # 3456
    with pytest.raises(ValueError, match="n_kv_heads"):
        ttp._check_divisible(TP_CFG, 3)


def test_capture_under_tp_is_accepted():
    """Both engines take capture=True (the default) under a group of more
    than one rank, and on the CPU run eagerly, as every CPU engine does:
    no graphs."""
    group = TPGroup(0, 2, None, "gloo", torch.device("cpu"), (0, 1))
    params = ttp.shard_params(tl.params_from_checkpoint(
        t_random(TP_CFG, seed=1), device="cpu"), TP_CFG, 2, 0)
    for cls in (InferenceEngine, BatchEngine):
        eng = cls(params, TP_CFG, None, device="cpu", tp=group)
        assert eng._graphs is None and eng._tp_size == 2


def test_split_capture_over_gloo(runs):
    """engine/graphs.py's split capture on each of 2 gloo ranks
    (torch_graph_standins.split_job, rank 0's result): 4 segments around
    two all-reduces and a gather, replayed in order on the tensors the
    body gave; another thread's collective during the capture and one
    outside it run at once. x starts at rank + 1 on each rank: 3 and 6
    after the eager call's all-reduces, 12 and 24 after the replay's."""
    check_split_job(runs[0][2]["split"], 24.0)


# ---------------------------------------------------------------------------
# mesh and multihost

def test_mesh_and_multihost_in_one_process():
    init_multihost(num_processes=1)  # a no-op: no process group
    assert is_coordinator()
    m = make_mesh()
    assert m.shape == {"dp": 1, "tp": 1} and m.tp_group.size == 1
    assert pod_mesh().shape == {"dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="dp\\*tp"):
        make_mesh(tp=3, dp=3)
    with pytest.raises(ValueError, match="backend"):
        init_multihost("file:///nowhere", 2, 0, backend="mpi")


def test_mesh_groups_over_four_ranks(runs):
    """make_mesh(tp=2, dp=2) over 4 ranks: rows of consecutive ranks are
    the tp groups, columns the dp groups; rank 0 alone coordinates."""
    rows = runs[0][4]["mesh"]
    for r, row in enumerate(rows):
        assert row["rank"] == r
        assert row["shape"] == {"dp": 2, "tp": 2}
        assert row["tp_rank"] == r % 2 and row["dp_index"] == r // 2
        assert row["tp_ranks"] == (r - r % 2, r - r % 2 + 1)
        assert row["tp_sum"] == 2 * (r - r % 2) + 1   # its row's ranks
        assert row["dp_sum"] == (r % 2) * 2 + 2       # its column's
        assert row["coordinator"] == (r == 0)


# ---------------------------------------------------------------------------
# engines

def test_tp_engine_stream_matches_jax_and_single_device(runs):
    """A TP InferenceEngine's greedy stream (f32 activations) equals the
    JAX InferenceEngine(mesh=...)'s (its forward bound to fused=True) and
    the port's single-device engine's; every rank drew the same tokens."""
    res, paths = runs
    toks, disagree = res[2]["engine"]
    assert disagree == 0 and len(toks) == 24 - len(ENGINE_PROMPT) + 1
    ckpt = t_load(paths["engine"])
    single = InferenceEngine(
        tl.params_from_checkpoint(ckpt, device="cpu",
                                  param_dtype=torch.float32),
        ENGINE_CFG, None, temperature=0.0, max_seq=64, device="cpu",
        act_dtype=torch.float32)
    assert single.generate_benchmark(ENGINE_PROMPT, 24)[0] == toks
    cfg, mesh, params, fwd = _jax_setup(paths["engine"], 2, "float32")
    jeng = JEngine(params, cfg, None, act_dtype=jnp.float32,
                   temperature=0.0, max_seq=64, mesh=mesh)
    jeng._fwd = fwd
    assert jeng.generate_benchmark(ENGINE_PROMPT, 24)[0] == toks


def test_tp_engine_replayed_stale_gives_the_same_stream(runs):
    """The TP InferenceEngine of test_tp_engine_stream_matches_jax_and_
    single_device, made with capture=True and its bodies replayed stale
    (each key's first body, _StaleSet), gives the stream that test holds
    to the JAX TP engine and the single-device engine: no TP body reads
    a per-call host value."""
    res = runs[0][2]
    toks, disagree = res["engine_stale"]
    assert disagree == 0 and toks == res["engine"][0]


@pytest.mark.parametrize("name", ["batch", "batch_spec"])
def test_tp_batch_engine_replayed_stale_gives_the_same_streams(runs, name):
    """The TP BatchEngines of test_tp_batch_engine_matches_single_device
    (forced chunks, block prefill, prefix-cache copies, spec blocks),
    made with capture=True and replayed stale on both ranks, give the
    streams that test holds to the single-device engine."""
    res = runs[0][2]
    assert res[name + "_stale"] == res[name] and all(res[name][0][0])


def test_tp_batch_engine_matches_single_device(runs):
    """A TP BatchEngine (rank 0 serves, rank 1 follows the broadcast
    dispatches: forced chunks, a 140-token prompt's block prefill, prefix
    cache copies on the second round, spec blocks) gives the
    single-device engine's greedy streams."""
    res, paths = runs
    ckpt = t_load(paths["engine"])
    params = tl.params_from_checkpoint(ckpt, device="cpu")
    for name in ("batch", "batch_spec"):
        _, job = next((j["name"], j) for j in _jobs(2, paths)
                      if j["name"] == name)
        streams, prefix = res[2][name]
        be = BatchEngine(params, ENGINE_CFG, None, device="cpu",
                         **job["kw"])
        for got in streams:
            be.reset()
            rids = [be.submit(p, max_new=job["max_new"])
                    for p in job["prompts"]]
            out = be.run()
            assert got == [out[r] for r in rids]
            assert all(got)
        if name == "batch":
            assert prefix["hits"] == 1 and prefix["rows_saved"] == 128


# ---------------------------------------------------------------------------
# the CLI and the server

def _model(tmp_path):
    path, tok = str(tmp_path / "m.bin"), str(tmp_path / "tok.bin")
    t_save(path, t_random(ENGINE_CFG, seed=5))
    write_toy_tokenizer(tok, _toy_vocab(ENGINE_CFG.vocab_size))
    return path, tok


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def test_cli_tp_prints_the_single_device_stream(tmp_path, capsys):
    """`python -m llama_cu_awq_torch <bin> --device cpu --tp 2 -t 0`
    prints what the single-device CLI prints (rank 0 only), and the
    stats line."""
    path, tok = _model(tmp_path)
    args = [path, "-n", "24", "-i", "the cat sat", "-t", "0", "-s", "3",
            "-z", tok, "--device", "cpu"]
    assert t_main(args) == 0
    want = capsys.readouterr().out
    out = subprocess.run([sys.executable, "-m", "llama_cu_awq_torch", *args,
                          "--tp", "2"], cwd=REPO, env=ENV, timeout=300,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr

    def text(s):
        return [ln for ln in s.splitlines() if "tok/s" not in ln]

    assert text(out.stdout) == text(want)
    assert out.stdout.count("achieved tok/s") == 1


def _serve(path, tok, tp):
    proc = subprocess.Popen(
        [sys.executable, "-m", "llama_cu_awq_torch.serve", path, "-z", tok,
         "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--slots", "2", "--tp", str(tp), "-t", "0", "--prefix-cache", "2"],
        cwd=REPO, env=ENV, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    killer = threading.Timer(300, proc.kill)
    killer.start()
    for line in proc.stderr:
        m = re.search(r"serving on 127\.0\.0\.1:(\d+)", line)
        if m:
            return proc, killer, int(m.group(1))
    killer.cancel()
    raise AssertionError(f"the server did not start: {proc.wait()}")


def _complete(port, prompt, n):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps({"prompt": prompt, "max_tokens": n}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["choices"][0]["token_ids"]


def test_serve_tp_completion_matches_single_device(tmp_path):
    """`serve --device cpu --tp 2` (rank 0 serves, rank 1 follows) answers
    the single-device server's greedy completions, a long prompt's block
    prefill and spec blocks included, and stops both ranks on SIGINT."""
    path, tok = _model(tmp_path)
    prompts = ["the cat sat on the mat the cat", "the mat " * 40]
    got = {}
    for tp in (1, 2):
        proc, killer, port = _serve(path, tok, tp)
        try:
            got[tp] = [_complete(port, p, 8) for p in prompts]
        finally:
            proc.send_signal(signal.SIGINT)
            code = proc.wait(timeout=120)
            killer.cancel()
        assert code == 0
    assert got[2] == got[1] and all(got[1])
