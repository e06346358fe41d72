"""The port's BatchEngine against the JAX package's, on the CPU.

Both engines serve the same requests over the same weights (a checkpoint
made with numpy from a seed, carried across with params_from_numpy), and
must give identical token streams and stats() counters. The JAX engine's
forward is bound to fused=True, the path the port runs (the JAX engine on
the CPU would pick its unfused path, which rounds differently), as
tests/test_torch_engine.py does for the CLI. Scenarios follow
tests/test_batch_engine.py, test_batch_spec.py, test_prefix_cache.py and
test_per_request_sampling.py. head_dim 16 keeps both packages on plain
attention throughout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.engine import BatchEngine as TBatchEngine
from llama_cu_awq_torch.engine import batch as t_batch
from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_torch.ops.cuda import LAUNCHES, count, reset_launches
from llama_cu_awq_tpu.config import ModelConfig
from llama_cu_awq_tpu.engine import engine as j_engine_mod
from llama_cu_awq_tpu.engine.batch import BatchEngine as JBatchEngine
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint
from llama_cu_awq_tpu.models import llama as jl
from tests.test_torch_graphs import _StaleSet

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
torch.set_num_threads(1)

CFG = ModelConfig(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                  n_kv_heads=2, vocab_size=512, seq_len=256)
PROMPTS = [[1, 5, 9, 100], [1, 42], [1, 7, 8, 9, 10, 11, 12],
           [1, 301, 17, 4], [1, 250]]
# over FORCED_PROMPT_MAX: block prefill on the slot, interleaved
LONG = [1] + [(17 * i) % 500 for i in range(60)]
# a body of more than one PREFILL_BLOCK: a prefix-cache entry
PREFIX = [1] + [(7 + 3 * i) % 200 for i in range(168)]
# repeats, so prompt lookup proposes
LOOPY = [[1, 5, 9, 13, 5, 9, 13, 5, 9], [1, 42, 43, 42, 43, 42],
         [1, 7, 8, 9, 7, 8]]


@pytest.fixture(scope="module")
def engines():
    """make(name, **kw) -> (JAX engine, port engine), built once per name
    and reset before each use (compiled JAX steps are kept). A name
    ending in "_stale" gives the port engine a _StaleSet: its bodies
    replay the first body of their key, as CUDA graphs would."""
    ckpt = random_checkpoint(CFG, seed=7)
    jp = jl.params_from_checkpoint(ckpt, param_dtype=jnp.bfloat16)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CFG,
                              device="cpu")
    built = {}

    def make(name, **kw):
        if name not in built:
            kw.setdefault("max_seq", 256)
            kw.setdefault("chunk_size", 4)
            built[name] = (JBatchEngine(jp, CFG, **kw),
                           TBatchEngine(tp, CFG, device="cpu", **kw))
            if name.endswith("_stale"):
                built[name][1]._graphs = _StaleSet()
        for be in built[name]:
            be.reset()
        return built[name]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_engine_mod, "forward",
                   functools.partial(jl.forward, fused=True))
        yield make


def _counters(stats):
    return {k: v for k, v in stats.items()
            if k in ("finished", "total_tokens", "spec", "prefix_cache")}


def _both(pair, scenario):
    """Run scenario(engine) -> (outputs, ...) on both engines; the
    outputs and the stats() counters must be equal."""
    jbe, tbe = pair
    want, got = scenario(jbe), scenario(tbe)
    assert got == want
    assert _counters(tbe.stats()) == _counters(jbe.stats())
    return got


def _serve(prompts, max_new, **sub):
    def scenario(be):
        rids = [be.submit(p, max_new=max_new, **sub) for p in prompts]
        out = be.run()
        assert be.scheduler.num_active == be.scheduler.num_queued == 0
        return [out[r] for r in rids]
    return scenario


def test_more_requests_than_slots(engines):
    """5 requests over 3 slots: queueing and slot reuse."""
    outs = _both(engines("a", n_slots=3), _serve(PROMPTS, 12))
    assert all(len(o) == 12 for o in outs)


def test_long_prompt_interleaved_prefill(engines):
    """Two long prompts prefill block by block on their slots while a
    short one decodes in the forced stream."""
    jbe, tbe = engines("a", n_slots=3)
    assert len(LONG) > tbe.FORCED_PROMPT_MAX == jbe.FORCED_PROMPT_MAX
    prefills = []
    orig = tbe._prefill_slot

    def counted(*a, **k):
        prefills.append(a[1])  # the block's position
        return orig(*a, **k)

    tbe._prefill_slot = counted
    try:
        outs = _both((jbe, tbe), _serve(
            [[1, 42], LONG, LONG[:1] + LONG[5:]], 6))
    finally:
        del tbe._prefill_slot
    assert all(len(o) == 6 for o in outs)
    assert prefills == [0, 0]  # one 128-row block each


def test_cancel(engines):
    """A request cancelled mid-generation keeps its truncated output and
    frees its slot for a queued one; a queued request is cancelled before
    admission; a second cancel is refused."""
    def scenario(be):
        rids = [be.submit(p, max_new=10) for p in PROMPTS[:4]]
        be.step()  # three requests take the slots, one waits
        n_before = len(be._requests[rids[0]].out)
        assert be.cancel(rids[0]) and not be.cancel(rids[0])
        queued = be.submit([1, 77], max_new=5)
        assert be.cancel(queued)
        out = be.run()
        assert len(out[rids[0]]) == n_before
        assert out[queued] == []
        return [out[r] for r in rids]

    _both(engines("a", n_slots=3), scenario)


def test_capacity_cutoff(engines):
    """A request near the cache boundary stops at max_seq."""
    prompt = [1] + list(range(5, 16))  # 12 tokens: room for 4
    (out,) = _both(engines("c", n_slots=2, max_seq=16),
                   _serve([prompt], 0))
    assert 1 <= len(out) <= 16 - len(prompt)


def test_oversized_prompt_refused(engines):
    for be in engines("a", n_slots=3):
        with pytest.raises(ValueError, match="exceeds max_seq"):
            be.submit([1] + list(range(5, 260)), max_new=1)
        assert be.pending == 0


def test_seeded_per_request_sampling(engines):
    """Greedy, nucleus and plain-CDF requests in one batched step, with
    the engine's seeded coins: k x S coins a chunk on both sides."""
    def scenario(be):
        rids = [be.submit([1, 5, 9], max_new=8),
                be.submit([1, 7], max_new=8, temperature=0.9, topp=0.9),
                be.submit([1, 3, 4], max_new=8, temperature=1.0, topp=1.0)]
        out = be.run()
        return [out[r] for r in rids], be.rng.state

    (outs, _) = _both(engines("a", n_slots=3), scenario)
    assert all(len(o) == 8 for o in outs)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_ngram(engines, temperature):
    """spec='ngram' blocks, greedy and sampled: the same emissions and
    spec counters (blocks, consumed, proposed, accepted)."""
    outs = _both(engines("spec", n_slots=3, spec="ngram", spec_k=4),
                 _serve(LOOPY + [LONG], 12, temperature=temperature))
    assert all(1 <= len(o) <= 12 for o in outs)  # a sample may be EOS


def test_spec_proposals_accepted(engines):
    """Greedy spec rounds on looping prompts accept proposals, with equal
    spec counters on both sides."""
    jbe, tbe = engines("spec", n_slots=3, spec="ngram", spec_k=4)
    _both((jbe, tbe), _serve(LOOPY, 16))
    assert tbe.spec_stats["accepted"] > 0
    assert tbe.spec_stats == jbe.spec_stats


def test_prefix_cache_hits(engines):
    """The second request with the cached prefix admits by a row copy
    (one hit, one 128-row block saved) and decodes the same stream."""
    def scenario(be):
        r0 = be.submit(PREFIX, max_new=6)
        out0 = be.run()[r0]
        r1 = be.submit(PREFIX + [11, 12], max_new=6)
        out1 = be.run()[r1]
        return out0, out1

    pair = engines("prefix", n_slots=2, prefix_cache_size=2)
    _both(pair, scenario)
    st = pair[1].stats()["prefix_cache"]
    assert st["hits"] == 1 and st["rows_saved"] == 128
    # entries are (serial, rows), the rows clones, not views of the slot
    # cache (the serial names a tensor-parallel follower's own clones)
    ((_, rows),) = pair[1].prefix_cache._entries.values()
    assert rows[0][0].untyped_storage().data_ptr() != \
        pair[1].cache.k[0].untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# the step bodies as graphs replay them (engine/graphs.py), on the CPU

def _cancel_in_flight(be):
    """A request cancelled while a chunk that decodes it is in flight:
    the chunk's tokens for it are discarded, its slot goes to the queued
    request."""
    rids = [be.submit(p, max_new=10) for p in PROMPTS[:4]]
    be.step()
    in_flight = be._dispatch_chunk()
    n_before = len(be._requests[rids[1]].out)
    assert be.cancel(rids[1])
    be._process_chunk(in_flight)
    out = be.run()
    assert len(out[rids[1]]) == n_before
    return [out[r] for r in rids]


def _short_chunk_at_boundary(be):
    """A 12-token prompt in an 18-row cache: chunks of 4 from position 0,
    the last one of 2 steps."""
    rid = be.submit([1] + list(range(5, 16)), max_new=0)
    ks = []
    while be.pending:
        chunk = be._dispatch_chunk()
        ks.append(chunk["k"])
        be._process_chunk(chunk)
    assert ks[-1] == 2 < be.chunk_size
    return be._requests[rid].out, ks


def _prefix_hit(be):
    r0 = be.submit(PREFIX, max_new=6)
    out0 = be.run()[r0]
    r1 = be.submit(PREFIX + [11, 12], max_new=6, temperature=0.8)
    out1 = be.run()[r1]
    return out0, out1


def _run_after_reset(be):
    """A mixed greedy and sampled run, reset(), and the same run again."""
    outs = []
    for _ in range(2):
        be.reset()
        rids = [be.submit(p, max_new=8, temperature=0.9 * (i % 2))
                for i, p in enumerate(PROMPTS)]
        out = be.run()
        outs.append([out[r] for r in rids])
    return outs


def _sampled(be):
    rids = [be.submit([1, 5, 9], max_new=8),
            be.submit([1, 7], max_new=8, temperature=0.9, topp=0.9),
            be.submit([1, 3, 4], max_new=8, temperature=1.0, topp=1.0)]
    out = be.run()
    return [out[r] for r in rids], be.rng.state


# scenario -> (engine name and options, scenario)
STALE = {
    "more_requests_than_slots": (("a", {"n_slots": 3}), _serve(PROMPTS, 12)),
    "interleaved_prefill_two_slots": (("a", {"n_slots": 3}), _serve(
        [[1, 42], LONG, LONG[:1] + LONG[5:]], 6)),
    "seeded_sampling": (("a", {"n_slots": 3}), _sampled),
    "spec_greedy": (("spec", dict(n_slots=3, spec="ngram", spec_k=4)),
                    _serve(LOOPY + [LONG], 12, temperature=0.0)),
    "spec_sampled": (("spec", dict(n_slots=3, spec="ngram", spec_k=4)),
                     _serve(LOOPY + [LONG], 12, temperature=0.8)),
    "prefix_cache_hit": (("prefix", dict(n_slots=2, prefix_cache_size=2)),
                         _prefix_hit),
    "cancel_in_flight": (("a", {"n_slots": 3}), _cancel_in_flight),
    "short_chunk_at_boundary": (("c18", dict(n_slots=2, max_seq=18)),
                                _short_chunk_at_boundary),
    "run_after_reset": (("a", {"n_slots": 3}), _run_after_reset),
}


@pytest.mark.parametrize("scenario", list(STALE))
def test_graph_bodies_replayed_stale_match_jax(engines, scenario):
    """Every step body replays the first body captured for its key
    (_StaleSet: what a CUDA graph does with its baked-in arguments), and
    the streams and stats() counters still equal the JAX engine's: no
    body reads a tensor made for one call."""
    (name, kw), run = STALE[scenario]
    _both(engines(name + "_stale", **kw), run)


def test_batch_graph_keys_hold_the_host_choices(engines):
    """One key per kind and choice, block width, window and plan: the
    chunk's and the spec block's keys hold sampled, the prefill's its
    slot; no chunk length is in a key (a short chunk replays the full
    chunks' graph)."""
    _, be = engines("c18_stale", n_slots=2, max_seq=18)
    be._graphs.graphs.clear()
    _both(engines("c18_stale", n_slots=2, max_seq=18),
          _short_chunk_at_boundary)
    assert list(be._graphs.graphs) == [be._graph_key(("chunk", False), 1,
                                                     18)]
    _, be = engines("a_stale", n_slots=3)
    be._graphs.graphs.clear()
    be.submit(LONG, max_new=4)
    be.submit([1] + LONG[5:], max_new=4, temperature=0.5)
    be.run()
    keys = list(be._graphs.graphs)
    assert {k[0] for k in keys} == {("prefill", 0), ("prefill", 1),
                                    ("chunk", True)}
    assert all(k[1] == (128 if k[0][0] == "prefill" else 1) for k in keys)
    k128 = be._graph_key(("chunk", True), 1, 128)
    assert k128 != be._graph_key(("chunk", False), 1, 128)
    assert k128 != be._graph_key(("chunk", True), 1, 256)
    assert k128[3].attn_impl is None
    p0, p1 = (be._graph_key(("prefill", s), 128, 128) for s in (0, 1))
    assert p0 != p1 and p0[1:] == p1[1:]
    _, spec = engines("spec_stale", n_slots=3, spec="ngram", spec_k=4)
    assert spec._graph_key(("spec", False), 5, 128)[1:] == \
        spec._graph_key(("spec", True), 5, 128)[1:]


def test_reset_keeps_the_buffers_in_place(engines):
    """reset() zeroes the cache and the token carry in place: the graphs
    hold their addresses."""
    _, be = engines("a", n_slots=3)
    bufs = be.cache.k + be.cache.v + [be._tok, be._out, be._in.dev.pos]
    ptrs = [t.data_ptr() for t in bufs]
    _serve(PROMPTS, 6)(be)
    assert any(t.any() for t in be.cache.k)
    be.reset()
    assert [t.data_ptr() for t in bufs] == ptrs
    assert not any(t.any() for t in be.cache.k + be.cache.v + [be._tok])


def test_replays_add_the_launches_of_eager_steps(engines, monkeypatch):
    """With every forward counted as a launch, an engine whose bodies
    replay (each replay adds its capture's launches through
    add_launches, what it counts itself taken back) counts what an eager
    engine counts, chunk steps, prefill blocks and spec blocks alike."""
    real = t_batch.forward

    def counted(*a, **kw):
        count("int4_matmul_fused", f"T{a[2].shape[1]}")
        return real(*a, **kw)

    monkeypatch.setattr(t_batch, "forward", counted)
    got = {}
    for name, kw in (("spec", dict(n_slots=3, spec="ngram", spec_k=4)),
                     ("a", {"n_slots": 3})):
        for stale in ("", "_stale"):
            _, be = engines(name + stale, **kw)
            if stale:  # captures made before forward counted count none
                be._graphs.graphs.clear()
            reset_launches()
            _serve(LOOPY + [LONG], 10)(be)
            got[name + stale] = dict(LAUNCHES)
        assert got[name] == got[name + "_stale"]
        assert got[name]["int4_matmul_fused"] > 0
    reset_launches()


def test_snapshot_copies_host_arrays():
    """A dispatch's inputs never alias the host arrays the engine goes on
    mutating: _Inputs.push copies its host mirror into the device buffer
    the bodies read (from_numpy alone would alias it), float32 regions by
    their bits, and each region is a view of fixed address."""
    inp = t_batch._Inputs(torch.device("cpu"), 2, pos=((4,), torch.int32),
                          coins=((2, 4), torch.float32))
    ptrs = (inp.dev.pos.data_ptr(), inp.dev.coins.data_ptr())
    a = np.arange(4, dtype=np.int32)
    inp.host.pos[:] = a
    inp.host.coins[:] = 0.25
    inp.push()
    a += 10
    inp.host.pos[:] = a
    assert inp.dev.pos.tolist() == [0, 1, 2, 3]
    assert inp.dev.coins.dtype == torch.float32
    assert inp.dev.coins.tolist() == [[0.25] * 4] * 2
    inp.push()
    assert inp.dev.pos.tolist() == [10, 11, 12, 13]
    assert (inp.dev.pos.data_ptr(), inp.dev.coins.data_ptr()) == ptrs
