"""The port's HTTP server and router on the CPU, with real sockets.

A server on 127.0.0.1 over a CPU BatchEngine of a tiny model and a toy
tokenizer written to a temporary file: health, models and stats;
blocking and SSE completions whose token_ids equal the JAX BatchEngine's
for the same prompt (its forward bound to fused=True, the path the port
runs); stop sequences, chat, 429, 503, client disconnect and bad
requests; two CPU replicas behind one ServingEngine; and the port's
router over two port servers (completion, failover, all down).
"""

import functools
import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.config import ModelConfig as TModelConfig
from llama_cu_awq_torch.engine import BatchEngine
from llama_cu_awq_torch.io.checkpoint import random_checkpoint as t_random
from llama_cu_awq_torch.io.checkpoint import save_checkpoint as t_save
from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_torch.router import make_router
from llama_cu_awq_torch.serve import build_argparser, make_server
from llama_cu_awq_torch.serve import render_chat as t_render_chat
from llama_cu_awq_torch.tokenizer import Tokenizer
from llama_cu_awq_tpu.config import ModelConfig
from llama_cu_awq_tpu.engine import engine as j_engine_mod
from llama_cu_awq_tpu.engine.batch import BatchEngine as JBatchEngine
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint
from llama_cu_awq_tpu.models import llama as jl
from llama_cu_awq_tpu.serve import render_chat as j_render_chat
from tests.test_tokenizer import write_toy_tokenizer
from tests.test_torch_engine import _toy_vocab

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
torch.set_num_threads(1)

CFG = ModelConfig(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                  n_kv_heads=2, vocab_size=512, seq_len=96)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    tok_path = str(tmp_path_factory.mktemp("tok") / "tok.bin")
    write_toy_tokenizer(tok_path, _toy_vocab(CFG.vocab_size))
    jp = jl.params_from_checkpoint(random_checkpoint(CFG, seed=11),
                                   param_dtype=jnp.bfloat16)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CFG,
                              device="cpu")
    return jp, tp, Tokenizer(tok_path, CFG.vocab_size)


def _engine(tp, tok, **kw):
    kw.setdefault("n_slots", 2)
    return BatchEngine(tp, CFG, tok, max_seq=96, temperature=0.0,
                       chunk_size=4, device="cpu", **kw)


def _start(engines, tok, *, start=True, **kw):
    httpd, eng = make_server(engines, tok, host="127.0.0.1", port=0,
                             model_name="tiny-llama", **kw)
    if start:
        eng.start()
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd, eng


def _stop(httpd, eng):
    httpd.shutdown()
    eng.stop()
    httpd.server_close()


@pytest.fixture(scope="module")
def server(model):
    _, tp, tok = model
    base, httpd, eng = _start(_engine(tp, tok), tok)
    yield base, eng
    _stop(httpd, eng)


def _post(base, body, path="/v1/completions", timeout=120):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def _stream(base, body, path="/v1/completions"):
    req = urllib.request.Request(
        base + path, data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: "):
                events.append(line[len("data: "):])
    assert events[-1] == "[DONE]"
    payloads = [json.loads(e) for e in events[:-1]]
    assert payloads[-1]["choices"][0]["finish_reason"] == "stop"
    return payloads


def _jax_tokens(jp, prompt_ids, max_new, spec=None):
    """The JAX BatchEngine's greedy stream for one request."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_engine_mod, "forward",
                   functools.partial(jl.forward, fused=True))
        be = JBatchEngine(jp, CFG, n_slots=2, max_seq=96, temperature=0.0,
                          chunk_size=4, spec=spec, spec_k=4)
        rid = be.submit(prompt_ids, max_new=max_new)
        return be.run()[rid]


def test_health_models_stats(server):
    base, _ = server
    assert _get(base, "/health") == (200, {"status": "ok"})
    st, models = _get(base, "/v1/models")
    assert st == 200 and models["data"][0]["id"] == "tiny-llama"
    st, stats = _get(base, "/stats")
    assert st == 200 and stats["slots"] == 2 and stats["max_seq"] == 96


@pytest.mark.parametrize("spec", [None, "ngram"])
def test_completion_matches_jax_engine(model, spec):
    """token_ids equal the JAX BatchEngine's for the prompt, the text is
    their piecewise detokenization, and the SSE stream of the same
    request carries the same text."""
    jp, tp, tok = model
    prompt = "the cat sat on the mat the cat sat"
    base, httpd, eng = _start(_engine(tp, tok, spec=spec, spec_k=4), tok)
    try:
        st, body = _post(base, {"prompt": prompt, "max_tokens": 10})
        payloads = _stream(base, {"prompt": prompt, "max_tokens": 10})
    finally:
        _stop(httpd, eng)
    choice = body["choices"][0]
    ids = tok.encode(prompt, bos=True, eos=False)
    assert st == 200 and body["object"] == "text_completion"
    assert choice["token_ids"] == _jax_tokens(jp, ids, 10, spec)
    assert body["usage"]["completion_tokens"] == len(choice["token_ids"])
    prev, want = ids[-1], []
    for t in choice["token_ids"]:
        want.append(tok.safe_piece(tok.decode(prev, t)))
        prev = t
    assert choice["text"] == "".join(want)
    assert "".join(p["choices"][0]["text"] for p in payloads) == \
        choice["text"]


def test_stop_sequences(server):
    """A stop string from the unstopped greedy output truncates the
    completion right before it, blocking and streaming (held back across
    chunk boundaries), and frees the slot."""
    base, eng = server
    _, full = _post(base, {"prompt": "a cat", "max_tokens": 16})
    text = full["choices"][0]["text"]
    assert len(text) > 6
    stop = text[3:6]
    _, cut = _post(base, {"prompt": "a cat", "max_tokens": 16,
                          "stop": stop})
    assert cut["choices"][0]["text"] == text[:text.index(stop)]
    payloads = _stream(base, {"prompt": "a cat", "max_tokens": 16,
                              "stop": [stop, "zzzz"]})
    streamed = "".join(p["choices"][0]["text"] for p in payloads)
    assert streamed == text[:text.index(stop)]
    for _ in range(200):
        if eng.stats()["active_slots"] == 0:
            break
        time.sleep(0.01)
    assert eng.stats()["active_slots"] == 0


def test_chat(server):
    base, _ = server
    messages = [{"role": "system", "content": "be brief"},
                {"role": "user", "content": "the cat"},
                {"role": "assistant", "content": "sat"},
                {"role": "user", "content": "on the mat"}]
    assert t_render_chat(messages) == j_render_chat(messages)
    with pytest.raises(ValueError):
        t_render_chat(messages[:3])  # must end with a user turn
    st, body = _post(base, {"messages": messages, "max_tokens": 5},
                     path="/v1/chat/completions")
    assert st == 200 and body["object"] == "chat.completion"
    msg = body["choices"][0]["message"]
    assert msg["role"] == "assistant" and isinstance(msg["content"], str)
    payloads = _stream(base, {"messages": messages, "max_tokens": 5},
                       path="/v1/chat/completions")
    assert payloads[0]["object"] == "chat.completion.chunk"
    assert "".join(p["choices"][0]["delta"]["content"]
                   for p in payloads) == msg["content"]


def test_concurrent_requests_share_slots(server):
    """6 concurrent clients over 2 slots, 3 of them streaming."""
    base, eng = server
    results = {}

    def client(i):
        body = {"prompt": f"the cat {i}", "max_tokens": 4}
        if i % 2:
            results[i] = "".join(p["choices"][0]["text"]
                                 for p in _stream(base, body))
        else:
            results[i] = _post(base, body)[1]["choices"][0]["text"]

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert sorted(results) == list(range(6))
    assert eng.stats()["requests"] >= 6


def test_bad_requests(server):
    base, _ = server
    for body, path in ((b"{not json", "/v1/completions"),
                       (json.dumps({"prompt": "the " * 200,
                                    "max_tokens": 4}).encode(),
                        "/v1/completions"),
                       (json.dumps({"messages": "hi"}).encode(),
                        "/v1/chat/completions")):
        req = urllib.request.Request(base + path, data=body)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 400
    for bad in (123, ["ok", ""], ["a", "b", "c", "d", "e"]):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"prompt": "x", "max_tokens": 2, "stop": bad})
        assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base, "/nope")
    assert ei.value.code == 404


def _wait_requests(eng, n):
    for _ in range(500):
        if eng.total_requests >= n:
            return
        time.sleep(0.01)


def test_queue_overflow_429(model):
    """With the engine thread not started and max_queue=1, the second
    request is shed with 429; the first completes once it starts."""
    _, tp, tok = model
    base, httpd, eng = _start(_engine(tp, tok, n_slots=1), tok, start=False,
                              max_queue=1)
    try:
        codes = {}
        t = threading.Thread(target=lambda: codes.__setitem__(
            "first", _post(base, {"prompt": "the", "max_tokens": 2})[0]))
        t.start()
        _wait_requests(eng, 1)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"prompt": "cat", "max_tokens": 2})
        assert ei.value.code == 429
        eng.start()
        t.join(timeout=120)
        assert codes["first"] == 200
        assert eng.stats()["rejected_requests"] == 1
    finally:
        _stop(httpd, eng)


def test_max_streams_503(model):
    """A second SSE connection gets 503 while the first holds the only
    stream slot."""
    _, tp, tok = model
    base, httpd, eng = _start(_engine(tp, tok, n_slots=1), tok, start=False,
                              max_streams=1)
    try:
        t = threading.Thread(target=lambda: _stream(
            base, {"prompt": "hold", "max_tokens": 2}))
        t.start()
        _wait_requests(eng, 1)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _stream(base, {"prompt": "x", "max_tokens": 1})
        assert ei.value.code == 503
        eng.start()
        t.join(timeout=120)
        assert not t.is_alive()
    finally:
        _stop(httpd, eng)


def test_client_disconnect_cancels(model):
    """A streaming client that drops mid-generation has its request
    cancelled, and the single slot serves the next request."""
    _, tp, tok = model
    base, httpd, eng = _start(_engine(tp, tok, n_slots=1), tok)
    try:
        host, port = base[len("http://"):].split(":")
        body = json.dumps({"prompt": "the", "max_tokens": 80,
                           "stream": True}).encode()
        s = socket.create_connection((host, int(port)), timeout=60)
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        s.recv(1024)  # the stream has started
        s.close()
        st, _ = _post(base, {"prompt": "after", "max_tokens": 3})
        assert st == 200
        for _ in range(500):
            if eng.stats()["cancelled_requests"] >= 1:
                break
            time.sleep(0.01)
        assert eng.stats()["cancelled_requests"] >= 1
        assert eng.stats()["active_slots"] == 0
    finally:
        _stop(httpd, eng)


def test_two_replicas_share_load(model):
    """ServingEngine([be0, be1]): concurrent requests spread over both
    replicas, and each stream is the single engine's stream."""
    _, tp, tok = model
    base, httpd, eng = _start(
        [_engine(tp, tok, n_slots=1), _engine(tp, tok, n_slots=1)], tok)
    try:
        out = {}

        def client(i):
            out[i] = _post(base, {"prompt": "the cat sat",
                                  "max_tokens": 6})[1]
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stats = eng.stats()
    finally:
        _stop(httpd, eng)
    ids = {tuple(b["choices"][0]["token_ids"]) for b in out.values()}
    assert len(out) == 4 and len(ids) == 1
    assert stats["slots"] == 2
    per = [r["requests"] for r in stats["replicas"]]
    assert sum(per) == 4 and min(per) >= 1


def _keepalive_404(base):
    conn = http.client.HTTPConnection(base[len("http://"):], timeout=60)
    try:
        conn.request("POST", "/v1/embeddings", body=b'{"input": "xx"}',
                     headers={"Content-Type": "application/json"})
        r1 = conn.getresponse()
        r1.read()
        conn.request("GET", "/health")
        r2 = conn.getresponse()
        return r1.status, r2.status
    finally:
        conn.close()


def test_router_over_two_servers(model):
    """The port's router over two port servers: health, models, stats,
    concurrent completions reaching both backends, SSE pass-through, a
    keep-alive 404, then failover when one backend goes away."""
    _, tp, tok = model
    backends = [_start(_engine(tp, tok), tok) for _ in range(2)]
    rhttpd, router = make_router([b[0] for b in backends], host="127.0.0.1",
                                 port=0, retry_s=1.0)
    threading.Thread(target=rhttpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{rhttpd.server_address[1]}"
    try:
        assert _get(base, "/health")[0] == 200
        assert _get(base, "/v1/models")[1]["data"][0]["id"] == "tiny-llama"
        assert _get(base, "/stats")[1]["slots"] == 4
        results = []
        threads = [threading.Thread(target=lambda i=i: results.append(
            _post(base, {"prompt": f"the cat {i}", "max_tokens": 4})))
            for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert [st for st, _ in results] == [200] * 6
        assert all(b.served > 0 for b in router.backends)
        assert any(p["choices"][0]["text"] for p in _stream(
            base, {"prompt": "stream me", "max_tokens": 4}))
        assert _keepalive_404(base) == (404, 200)
        # failover: the first backend goes away
        httpd0, eng0 = backends[0][1:]
        _stop(httpd0, eng0)
        served1 = router.backends[1].served
        for _ in range(3):
            assert _post(base, {"prompt": "after", "max_tokens": 3})[0] == 200
        assert router.backends[1].served == served1 + 3
        assert _get(base, "/health")[0] == 200
    finally:
        rhttpd.shutdown()
        rhttpd.server_close()
        for _, httpd, eng in backends[1:]:
            _stop(httpd, eng)


def test_router_counts_before_the_answer(server):
    """The router counts a request as served before the client's last
    bytes go out: when the body of a plain JSON answer, or the
    terminating chunk of an SSE answer, is written to the client, the
    backend's `served` already includes that request. A client that
    reads /stats right after its answer then sees its request."""
    backend, _ = server
    rhttpd, router = make_router([backend], host="127.0.0.1", port=0)
    handler = rhttpd.RequestHandlerClass
    seen = []  # (kind of last write, served at that moment)

    class _Spy:
        """The connection's writer: notes `served` at the SSE
        terminator."""

        def __init__(self, f):
            self._f = f

        def write(self, data):
            if data == b"0\r\n\r\n":
                seen.append(("sse", router.backends[0].served))
            return self._f.write(data)

        def __getattr__(self, name):
            return getattr(self._f, name)

    raw, setup = handler._raw, handler.setup

    def spy_raw(self, code, ctype, body):
        if self.command == "POST":
            seen.append(("json", router.backends[0].served))
        return raw(self, code, ctype, body)

    def spy_setup(self):
        setup(self)
        self.wfile = _Spy(self.wfile)

    handler._raw, handler.setup = spy_raw, spy_setup
    threading.Thread(target=rhttpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{rhttpd.server_address[1]}"
    try:
        assert _post(base, {"prompt": "the cat", "max_tokens": 3})[0] == 200
        assert seen == [("json", 1)]
        assert router.backends[0].served == 1
        assert _stream(base, {"prompt": "the mat", "max_tokens": 3})
        assert seen == [("json", 1), ("sse", 2)]
        assert _get(base, "/stats")[1]["backends"][0]["served"] == 2
        assert router.backends[0].inflight == 0
    finally:
        rhttpd.shutdown()
        rhttpd.server_close()


def test_router_all_down_503():
    rhttpd, _ = make_router(["http://127.0.0.1:9"], host="127.0.0.1",
                            port=0, retry_s=0.1)
    threading.Thread(target=rhttpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{rhttpd.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"prompt": "x", "max_tokens": 1}, timeout=60)
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base, "/health")
        assert ei.value.code == 503
    finally:
        rhttpd.shutdown()
        rhttpd.server_close()


def test_serve_cli_flags(tmp_path):
    """serve's flags: the JAX server's, with --device in place of
    --platform and without --impl; --dp with --tp is taken: main gets
    past the flags and stops at the missing checkpoint."""
    from llama_cu_awq_torch.serve import main

    args = build_argparser().parse_args(["m.bin", "--device", "cpu",
                                         "--dp", "2", "--tp", "2"])
    assert (args.device, args.dp, args.tp, args.spec, args.slots) == (
        "cpu", 2, 2, "ngram", 16)
    with pytest.raises(SystemExit):
        build_argparser().parse_args(["m.bin", "--impl", "pallas"])
    missing = str(tmp_path / "m.bin")
    with pytest.raises(FileNotFoundError, match="m.bin"):
        main([missing, "--tp", "2", "--dp", "2", "--device", "cpu"])


def test_serve_card_check_counts_dp_times_tp(tmp_path, monkeypatch):
    """With --device cuda, main needs --dp x --tp cards and exits before
    it reads the checkpoint where the host has fewer (the JAX server's
    check, llama_cu_awq_tpu/serve.py:630-632)."""
    from llama_cu_awq_torch import device as t_device
    from llama_cu_awq_torch.serve import main

    monkeypatch.setattr(t_device, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    missing = str(tmp_path / "m.bin")
    with pytest.raises(SystemExit, match="--dp 2 x --tp 2 needs 4 cards, "
                                         "have 1"):
        main([missing, "--tp", "2", "--dp", "2"])
    with pytest.raises(FileNotFoundError):
        main([missing])  # one card is enough for one


def test_served_head_is_the_checkpoints_fp16(tmp_path):
    """At --tp 1 the server's params keep the checkpoint's fp16 embed and
    lm_head (param_dtype None), the JAX server's choice
    (llama_cu_awq_tpu/serve.py:641); under --tp the bf16 default of
    tp_params_from_checkpoint (:639). A greedy completion served by the
    engine serve.main builds equals the JAX BatchEngine's on the same
    .bin."""
    from llama_cu_awq_torch import serve as t_serve
    from llama_cu_awq_torch.io.checkpoint import load_checkpoint as t_load
    from llama_cu_awq_torch.parallel.tp import tp_params_from_checkpoint
    from llama_cu_awq_tpu.io.checkpoint import load_checkpoint as j_load

    ckpt_path, tok_path = str(tmp_path / "m.bin"), str(tmp_path / "t.bin")
    t_save(ckpt_path, t_random(TModelConfig(
        dim=256, hidden_dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
        vocab_size=512, seq_len=96), seed=11))
    write_toy_tokenizer(tok_path, _toy_vocab(512))
    args = build_argparser().parse_args(
        [ckpt_path, "-z", tok_path, "--device", "cpu", "--slots", "2",
         "--chunk-size", "4", "-t", "0", "--spec", "none"])
    ckpt = t_load(ckpt_path)
    tok = Tokenizer(tok_path, ckpt.config.vocab_size)
    be = t_serve._engine(args, ckpt, tok, "cpu")
    jp = jl.params_from_checkpoint(j_load(ckpt_path))  # the JAX server's
    assert be.params.lm_head.dtype == torch.float16
    assert be.params.embed.dtype == torch.float16
    assert str(jp.lm_head.dtype) == "float16"
    assert np.array_equal(be.params.lm_head.numpy(), np.asarray(jp.lm_head))
    assert tp_params_from_checkpoint(ckpt, 2, 0, device="cpu").lm_head.dtype \
        == torch.bfloat16
    prompt = "the cat sat on the mat the cat"
    base, httpd, eng = _start(be, tok)
    try:
        _, body = _post(base, {"prompt": prompt, "max_tokens": 10})
    finally:
        _stop(httpd, eng)
    ids = tok.encode(prompt, bos=True, eos=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_engine_mod, "forward",
                   functools.partial(jl.forward, fused=True))
        jbe = JBatchEngine(jp, ckpt.config, n_slots=2, max_seq=96,
                           temperature=0.0, chunk_size=4)
        rid = jbe.submit(ids, max_new=10)
        want = jbe.run()[rid]
    assert body["choices"][0]["token_ids"] == want and want


def test_serve_main_logs_startup_line(tmp_path):
    """`python -m llama_cu_awq_torch.serve` writes its "serving on" line
    to stderr: the port's utils/logging gives its root logger a stderr
    handler at INFO."""
    cfg = TModelConfig(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                       n_kv_heads=2, vocab_size=512, seq_len=96)
    ckpt, tok = str(tmp_path / "m.bin"), str(tmp_path / "tok.bin")
    t_save(ckpt, t_random(cfg, seed=11))
    write_toy_tokenizer(tok, _toy_vocab(cfg.vocab_size))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "llama_cu_awq_torch.serve", ckpt, "-z", tok,
         "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
         "--slots", "1", "--spec", "none"], cwd=repo,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    killer = threading.Timer(120, proc.kill)
    killer.start()
    lines = []
    try:
        for line in proc.stderr:
            lines.append(line)
            if "serving on" in line:
                break
    finally:
        killer.cancel()
        proc.terminate()
        proc.wait(timeout=60)
    assert any("llama_cu_awq_torch.serve INFO serving on 127.0.0.1:" in s
               and "(1 slots x 1 replicas, max_seq 96)" in s
               for s in lines), lines
