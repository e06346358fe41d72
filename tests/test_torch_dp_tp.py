"""`serve --dp 2 --tp 2` on the CPU: two replicas of two gloo ranks each,
built by the server's own replica builder (serve.run_replicas), with
both replicas' rank 0 in this process (parallel/mesh.py
make_replica_groups) and ranks 1 and 2 spawned, one shard each.

One set of ranks serves every case of the module (the module fixture);
each case puts the two leader engines behind make_server, as serve.main
does. The oracle is the JAX server's own layout on the virtual CPU
devices (tests/conftest.py): two JAX BatchEngines, each over
make_mesh(tp=2, dp=1, devices=jax.devices()[2r:2r + 2]), behind the JAX
make_server, on the same `.bin`, with tests/test_torch_tp.py's settings
(its forward bound to fused=True with the kernels' bf16 staging, scales
that bf16 holds exactly). The behaviours are those tests/test_serve_dp.py
pins for the JAX server, here at tp 2; the last case stops the server
and holds every rank to exit code 0.
"""

import contextlib
import functools
import json
import multiprocessing
import threading
import time
import urllib.error
import urllib.request

import jax
import pytest
import torch

from llama_cu_awq_torch import serve as t_serve
from llama_cu_awq_torch.config import ModelConfig as TModelConfig
from llama_cu_awq_torch.engine import BatchEngine
from llama_cu_awq_torch.io.checkpoint import load_checkpoint as t_load
from llama_cu_awq_torch.io.checkpoint import random_checkpoint as t_random
from llama_cu_awq_torch.io.checkpoint import save_checkpoint as t_save
from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_torch.parallel import replica_ranks, replica_shard
from llama_cu_awq_torch.parallel.mesh import default_replica_devices
from llama_cu_awq_torch.tokenizer import Tokenizer
from llama_cu_awq_tpu import serve as j_serve
from llama_cu_awq_tpu.engine.batch import BatchEngine as JBatchEngine
from llama_cu_awq_tpu.io.checkpoint import load_checkpoint as j_load
from llama_cu_awq_tpu.models import llama as jl
from llama_cu_awq_tpu.parallel import make_mesh as j_make_mesh
from llama_cu_awq_tpu.parallel import tp as jtp
from llama_cu_awq_tpu.parallel.tp import place_params
from llama_cu_awq_tpu.tokenizer import Tokenizer as JTokenizer
from tests.test_tokenizer import write_toy_tokenizer
from tests.test_torch_act_dtype import _staged
from tests.test_torch_engine import _toy_vocab
from tests.test_torch_tp import _bf16_scales

torch.set_num_threads(1)

DP, TP = 2, 2
# tests/test_torch_tp.py's ENGINE_CFG: head_dim 128, so fused_step and the
# prefill kernel's plain versions run as on the card
CFG = TModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=2,
                   n_kv_heads=2, vocab_size=512, seq_len=256)
SERVE_ARGS = ["--device", "cpu", "--dp", str(DP), "--tp", str(TP),
              "--slots", "2", "-t", "0", "--max-seq", "256", "-s", "7"]
# the last prompt is long enough for block prefill (>= 64 tokens)
PROMPTS = ["the cat sat on the mat the cat", "a cat sat on a mat",
           "on the mat on the", "the mat " * 40]
MAX_NEW = 8


class _Served:
    """The ranks of the module: the two leader engines, and how to stop
    them (release) and read run_replicas's exit code (rc)."""

    def __init__(self, path, tok_path):
        self.path = path
        self.args = t_serve.build_argparser().parse_args(
            [path, "-z", tok_path, *SERVE_ARGS])
        self.ckpt = t_load(path)
        self.tok = Tokenizer(tok_path, CFG.vocab_size)
        self.engines = None
        self.rc = None
        self.error = None
        self._ready = threading.Event()
        self._release = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _body(self, engines):
        self.engines = engines
        self._ready.set()
        self._release.wait()  # the module's cases run meanwhile
        return 0

    def _run(self):
        try:
            self.rc = t_serve.run_replicas(self.args, self.ckpt, self.tok,
                                           self._body)
        except Exception as e:  # raised again by start() and stop()
            self.error = e
        finally:
            self._ready.set()

    def start(self):
        self._thread.start()
        assert self._ready.wait(300), "the replicas did not come up"
        if self.error is not None:
            raise self.error

    def stop(self) -> int:
        self._release.set()
        self._thread.join(timeout=300)
        assert not self._thread.is_alive(), "run_replicas did not return"
        if self.error is not None:
            raise self.error
        return self.rc


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_tp")
    path, tok = str(tmp / "m.bin"), str(tmp / "tok.bin")
    t_save(path, _bf16_scales(t_random(CFG, seed=5)))
    write_toy_tokenizer(tok, _toy_vocab(CFG.vocab_size))
    s = _Served(path, tok)
    s.start()
    yield s
    s.stop()


@contextlib.contextmanager
def _server(s, *, max_queue=256, start=True):
    """The leader engines behind make_server, as serve._serve puts them:
    (base URL, ServingEngine); the engine threads run unless start is
    False (the caller then starts them)."""
    httpd, eng = t_serve.make_server(s.engines, s.tok, host="127.0.0.1",
                                     port=0, max_queue=max_queue)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    if start:
        eng.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", eng
    finally:
        eng.stop()
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)


def _post(base, body, timeout=300):
    req = urllib.request.Request(
        base + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _complete_all(base, prompts, **kw):
    """Concurrent greedy completions; their token_ids in prompt order."""
    out = [None] * len(prompts)

    def one(i):
        st, body = _post(base, {"prompt": prompts[i], "max_tokens": MAX_NEW,
                                "temperature": 0.0, **kw})
        assert st == 200
        out[i] = body["choices"][0]["token_ids"]

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(o is not None for o in out)
    return out


def _drain(q, timeout=300):
    toks = []
    while True:
        item = q.get(timeout=timeout)
        if item is None:
            return toks
        toks.extend(item)


def _wait_queued(eng, n, timeout=60):
    t_end = time.monotonic() + timeout
    while eng.stats()["queued_requests"] < n:
        assert time.monotonic() < t_end, eng.stats()
        time.sleep(0.05)


@pytest.fixture(scope="module")
def want(served):
    """Each prompt's greedy completion from the port's single-device
    BatchEngine with the TP ranks' bf16 head (tp_params_from_checkpoint's
    default): the streams every replica must give."""
    be = BatchEngine(tl.params_from_checkpoint(served.ckpt, device="cpu"),
                     CFG, served.tok, n_slots=2, max_seq=256, device="cpu",
                     temperature=0.0, spec="ngram")
    out = {}
    for p in PROMPTS:
        rid = be.submit(p, max_new=MAX_NEW)
        out[p] = be.run()[rid]
    return out


# ---------------------------------------------------------------------------
# the layout

def test_replica_layout():
    """Replica r's group is (0, 1 + r*(M-1), ..., (r+1)*(M-1)); every
    rank >= 1 maps back to its (replica, shard); the default devices are
    the JAX server's devices[r*tp:(r+1)*tp], in shard order."""
    assert replica_ranks(2, 2) == [(0, 1), (0, 2)]
    assert replica_ranks(3, 4) == [(0, 1, 2, 3), (0, 4, 5, 6),
                                   (0, 7, 8, 9)]
    assert replica_ranks(1, 3) == [(0, 1, 2)]  # --tp alone
    for dp, tp in ((2, 2), (3, 4), (1, 3), (4, 2)):
        groups = replica_ranks(dp, tp)
        world = 1 + dp * (tp - 1)
        assert sorted({k for g in groups for k in g}) == list(range(world))
        for k in range(1, world):
            r, c = replica_shard(k, tp)
            assert groups[r][c] == k
        devs = default_replica_devices(dp, tp, "nccl")
        jdevs = [f"cuda:{i}" for i in range(dp * tp)]
        for r in range(dp):
            assert devs[r * tp:(r + 1) * tp] == jdevs[r * tp:(r + 1) * tp]
        assert default_replica_devices(dp, tp, "gloo") == ["cpu"] * (dp * tp)
    with pytest.raises(ValueError, match="holds no one replica"):
        replica_shard(0, 2)


def test_replica_groups_of_the_served_ranks(served):
    """This process holds shard 0 of both replicas, over gloo on the CPU,
    and each replica's leader engine carries its own group and seed."""
    assert len(served.engines) == DP
    for r, be in enumerate(served.engines):
        g = be.tp
        assert (g.rank, g.size, g.backend) == (0, TP, "gloo")
        assert g.ranks == replica_ranks(DP, TP)[r] and g.src == 0
        assert g.device == torch.device("cpu")
        assert be.n_slots == 2 and be.max_seq == 256 and be.spec == "ngram"
    groups = [be.tp.group for be in served.engines]
    assert groups[0] is not groups[1]
    seeds = [be.rng.state for be in served.engines]
    assert seeds[0] != seeds[1]  # args.seed + r


# ---------------------------------------------------------------------------
# against the JAX server's --dp 2 --tp 2

@pytest.fixture(scope="module")
def jax_replicas(served):
    """The JAX server's replicas (llama_cu_awq_tpu/serve.py:621-651) on
    devices [0, 1] and [2, 3], on the kernel path's numerics."""
    ckpt = j_load(served.path)
    cfg = ckpt.config
    host = jtp.tp_params_from_checkpoint(ckpt, TP)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jl, "qmatmul_fused", _staged(jl.qmatmul_fused))
        mp.setattr(jtp, "forward", functools.partial(jl.forward, fused=True))
        engines = []
        for i in range(DP):
            mesh = j_make_mesh(tp=TP, dp=1,
                               devices=jax.devices()[i * TP:(i + 1) * TP])
            engines.append(JBatchEngine(
                place_params(host, cfg, mesh), cfg,
                JTokenizer(served.args.tokenizer, cfg.vocab_size),
                n_slots=2, max_seq=256, temperature=0.0, seed=7 + i,
                spec="ngram", spec_k=7, chunk_size=8, mesh=mesh))
        yield engines


def test_dp_tp_completions_match_the_jax_server(served, jax_replicas, want):
    """The same prompts, sent at once to both servers: equal greedy
    completions token for token, and equal to the single-device
    engine's."""
    with _server(served) as (base, eng):
        got = _complete_all(base, PROMPTS)
        per = [p["requests"] for p in eng.stats()["replicas"]]
    httpd, jeng = j_serve.make_server(jax_replicas, jax_replicas[0].tokenizer,
                                      host="127.0.0.1", port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    jeng.start()
    try:
        jgot = _complete_all(f"http://127.0.0.1:{httpd.server_address[1]}",
                             PROMPTS)
    finally:
        jeng.stop()
        httpd.shutdown()
        httpd.server_close()
    assert got == jgot
    assert got == [want[p] for p in PROMPTS]
    assert all(len(g) == MAX_NEW for g in got)
    assert sum(per) == len(PROMPTS)


# ---------------------------------------------------------------------------
# tests/test_serve_dp.py's behaviours, at tp 2

def test_dp_tp_replicas_share_load(served, want):
    """4 concurrent HTTP requests queued before the engine threads start:
    both replicas serve 2, every stream is the greedy one, and the
    aggregate stats sum over the replicas."""
    with _server(served, start=False) as (base, eng):
        box = {}
        t = threading.Thread(target=lambda: box.setdefault(
            "out", _complete_all(base, PROMPTS)))
        t.start()
        _wait_queued(eng, len(PROMPTS))
        eng.start()
        t.join(timeout=300)
        st = eng.stats()
    assert box["out"] == [want[p] for p in PROMPTS]
    assert st["requests"] == 4 and st["generated_tokens"] == 4 * MAX_NEW
    assert [p["requests"] for p in st["replicas"]] == [2, 2]
    assert st["slots"] == DP * 2
    assert st["active_slots"] == st["queued_requests"] == 0


def test_dp_tp_routing_spreads_idle_replicas(served, want):
    """Least-loaded routing with the engine threads stopped: 4 submits
    land 2/2, in turns; then both replicas drain them."""
    with _server(served, start=False) as (_, eng):
        subs = [eng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
        assert [rid[0] for rid, _ in subs] == [0, 1, 0, 1]
        assert [p["queued_requests"]
                for p in eng.stats()["replicas"]] == [2, 2]
        eng.start()
        got = [_drain(q) for _, q in subs]
    assert got == [want[p] for p in PROMPTS]


def test_dp_tp_cancel_routes_to_owner(served, want):
    """cancel() reaches the replica that owns the request: a queued
    request leaves its replica's queue; a running one frees its slot.
    The owning replica's follower stays in step: its next request gives
    the greedy stream."""
    with _server(served, start=False) as (_, eng):
        rid0, _ = eng.submit(PROMPTS[0], max_new=MAX_NEW)
        rid1, q1 = eng.submit(PROMPTS[1], max_new=MAX_NEW)
        assert rid0[0] != rid1[0]
        eng.cancel(rid0)
        st = eng.stats()
        assert st["cancelled_requests"] == 1
        assert st["replicas"][rid0[0]]["queued_requests"] == 0
        assert st["replicas"][rid1[0]]["queued_requests"] == 1
        eng.start()
        assert _drain(q1) == want[PROMPTS[1]]
        # a running request: cancelled after its first tokens
        rid, q = eng.submit(PROMPTS[2], max_new=200)
        first = q.get(timeout=300)
        assert first
        eng.cancel(rid)
        owner = eng.replicas[rid[0]]
        t_end = time.monotonic() + 60
        while eng.stats()["replicas"][rid[0]]["active_slots"]:
            assert time.monotonic() < t_end
            time.sleep(0.05)
        assert eng.stats()["cancelled_requests"] == 2
        assert owner.inflight == 0
        # the owner serves the next request (least loaded, lowest index)
        rid2, q2 = eng.submit(PROMPTS[3], max_new=MAX_NEW)
        assert _drain(q2) == want[PROMPTS[3]]


def test_dp_tp_global_queue_bound(served):
    """max_queue bounds the waiting requests over both replicas: the
    third request gets HTTP 429."""
    with _server(served, max_queue=2, start=False) as (base, eng):
        held = [eng.submit(p, max_new=4) for p in PROMPTS[:2]]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"prompt": PROMPTS[2], "max_tokens": 4}, timeout=60)
        assert ei.value.code == 429
        assert eng.stats()["rejected_requests"] == 1
        eng.start()
        for _, q in held:
            assert len(_drain(q)) == 4


def test_dp_tp_composes_with_spec(served, want):
    """Each replica runs the speculative loop (the server's default
    spec="ngram"): concurrent greedy and sampled requests all finish on
    both replicas, spec blocks ran on each, and the greedy ones give the
    greedy stream."""
    blocks = [be.spec_stats["blocks"] for be in served.engines]
    with _server(served, start=False) as (_, eng):
        subs = [(t, eng.submit("a b a b a b" if t else PROMPTS[0],
                               max_new=6, temperature=t))
                for t in (None, 0.7, None, 0.7)]
        assert [rid[0] for _, (rid, _) in subs] == [0, 1, 0, 1]
        eng.start()
        got = [(t, _drain(q)) for t, (_, q) in subs]
        assert all(r.be.scheduler.num_active == 0 for r in eng.replicas)
    for t, toks in got:
        assert 1 <= len(toks) <= 6
        if t is None:
            assert toks == want[PROMPTS[0]][:6]
    assert all(be.spec_stats["blocks"] > b
               for be, b in zip(served.engines, blocks))


# ---------------------------------------------------------------------------
# shutdown (last: it stops the module's ranks)

def test_dp_tp_shutdown_stops_every_rank(served):
    """When the server stops, every leader stops its follower: every rank
    exits with code 0, no process is left, and this process leaves the
    process group."""
    assert served.stop() == 0
    assert multiprocessing.active_children() == []
    assert not torch.distributed.is_initialized()
