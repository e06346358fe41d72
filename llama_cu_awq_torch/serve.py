"""HTTP serving front end over the continuous-batching engine.

The counterpart of llama_cu_awq_tpu/serve.py, stdlib only
(ThreadingHTTPServer and one engine thread per replica).

- `ServingEngine` owns one BatchEngine or a list of them (data-parallel
  replicas, one per card) and one thread per replica that drives it with
  BatchEngine.run()'s one-chunk lookahead. HTTP handler threads only
  enqueue requests and block on per-request token queues: they never
  touch a tensor, and each engine thread runs its CUDA work under its own
  device (torch.cuda.device). Each replica's engine owns its CUDA graphs
  (engine/graphs.py); they are captured and replayed on its engine
  thread.
- Endpoints (OpenAI-compatible shapes):
    POST /v1/completions   {"prompt", "max_tokens", "stream": bool,
                            "stop": str | [str, ...] (<= 4),
                            "temperature", "top_p"}
                           -> text_completion JSON (with the extension
                              field choices[0].token_ids), or an SSE
                              stream of {"choices": [{"text": piece}]};
                           a stop sequence truncates the output before
                           the match and frees the slot at once
    POST /v1/chat/completions  {"messages": [...], ...} rendered with the
                           Llama-2 chat schema (render_chat)
    GET  /v1/models, /health, /stats
- 429 when the admission queue is full, 503 over --max-streams
  concurrent streams, and a client that disconnects mid-stream cancels
  its request.

CLI: python -m llama_cu_awq_torch.serve model.bin -z tokenizer.bin \
         [--port 8000] [--slots 16] [--dp N] [--tp M] [--device cuda|cpu]

--dp N serves N replicas of the model, each request routed to the
least-loaded one. --tp M serves each replica in tensor parallelism over M
ranks (parallel/tp.py, engine/batch.py): this process is global rank 0,
owns HTTP, the queue and the schedulers, and holds shard 0 of every
replica (parallel/mesh.py make_replica_groups); it starts the other
N*(M-1) ranks itself (parallel/multihost.py run_ranks), each of which
builds its shard and follows its replica's dispatches. With --device cuda
replica r's shard c runs on cuda:r*M + c over nccl (N*M cards), with
--device cpu over gloo. TP engines run on CUDA graphs split at the
collectives (engine/graphs.py), on every rank.
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from llama_cu_awq_torch.tokenizer import BOS_TOKEN
from llama_cu_awq_torch.utils.logging import get_logger


class ServerOverloaded(Exception):
    """The admission queue is full; the client should retry (HTTP 429)."""


def _device_scope(device):
    """The engine thread's device context: its card for a CUDA engine."""
    import torch

    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _Replica:
    """One BatchEngine, the thread that steps it and the lock its scheduler
    mutates under. A request stays on the replica it was routed to (its
    KV rows live on that replica's card)."""

    def __init__(self, be, idx: int):
        self.be = be
        self.idx = idx
        self.lock = threading.Lock()
        self.work = threading.Condition(self.lock)
        self.thread: threading.Thread | None = None
        self.served = 0    # requests routed here
        self.inflight = 0  # live requests here (under the engine's _qlock)


class ServingEngine:
    """Thread-safe continuous-batching front end with streaming outputs.

    Takes one BatchEngine or a list of them (replicas): a request goes to
    the least-loaded replica at submit and stays there. max_queue bounds
    the waiting requests over all replicas: beyond it submit() raises
    ServerOverloaded, so an overloaded server sheds load with 429s."""

    def __init__(self, batch_engine, tokenizer, max_queue: int = 256):
        engines = (batch_engine if isinstance(batch_engine, (list, tuple))
                   else [batch_engine])
        self.replicas = [_Replica(be, i) for i, be in enumerate(engines)]
        self.be = engines[0]
        self.tokenizer = tokenizer
        self.max_queue = max_queue
        self._qlock = threading.Lock()   # queues and global counters
        self._queues: dict[tuple, queue.Queue] = {}
        self._running = False
        self.started_t = time.time()
        self.total_requests = 0
        self.total_tokens = 0
        self.rejected_requests = 0
        self.cancelled_requests = 0

    # -- lifecycle ------------------------------------------------------

    def start(self):
        self._running = True
        for r in self.replicas:
            r.thread = threading.Thread(
                target=self._loop, args=(r,), daemon=True,
                name=f"serving-engine-{r.idx}")
            r.thread.start()

    def stop(self):
        for r in self.replicas:
            with r.work:
                self._running = False
                r.work.notify()
        for r in self.replicas:
            if r.thread:
                r.thread.join(timeout=30)

    # -- request API (handler threads) ----------------------------------

    def submit(self, prompt: str | list[int], max_new: int,
               temperature: float | None = None,
               topp: float | None = None):
        """Queue a request; returns (request_id, token_queue). The queue
        yields lists of token ids, then None. The least-loaded replica by
        live requests (ties: the lowest index) is reserved under the
        registry lock, so concurrent submits spread."""
        q: queue.Queue = queue.Queue()
        with self._qlock:
            queued = sum(r.be.scheduler.num_queued for r in self.replicas)
            if queued >= self.max_queue:
                self.rejected_requests += 1
                raise ServerOverloaded(
                    f"admission queue full ({self.max_queue} waiting)")
            r = min(self.replicas, key=lambda x: (x.inflight, x.idx))
            r.inflight += 1
        try:
            with r.work:
                lrid = r.be.submit(prompt, max_new=max_new,
                                   temperature=temperature, topp=topp)
                rid = (r.idx, lrid)
                r.served += 1
                with self._qlock:
                    self._queues[rid] = q
                    self.total_requests += 1
                r.work.notify()
        except Exception:
            with self._qlock:
                r.inflight -= 1
            raise
        return rid, q

    def _drop_rid(self, rid) -> bool:
        """Remove a request from the registry once (the one owner of the
        inflight decrement). True if it was there."""
        with self._qlock:
            present = self._queues.pop(rid, None) is not None
            if present:
                self.replicas[rid[0]].inflight -= 1
        return present

    def cancel(self, rid):
        """Abort a request whose client went away: frees its slot or
        queue entry, so the engine stops decoding for it."""
        r = self.replicas[rid[0]]
        with r.lock:
            if r.be.cancel(rid[1]):
                with self._qlock:
                    self.cancelled_requests += 1
            r.be.drop_request(rid[1])
        self._drop_rid(rid)

    # -- engine threads (one per replica) --------------------------------

    def _loop(self, r: _Replica):
        with _device_scope(r.be.device):
            if r.be.spec:
                self._loop_spec(r)
            else:
                self._loop_chunks(r)

    def _loop_chunks(self, r: _Replica):
        """BatchEngine.run()'s lookahead loop, endless: chunk N+1 is
        queued before chunk N's tokens are fetched and routed. The fetch
        waits for the device outside the replica lock."""
        from llama_cu_awq_torch.engine.batch import _host
        from llama_cu_awq_torch.utils.profiling import span

        in_flight = None
        while True:
            with r.work:
                if not self._running:
                    break
                nxt = r.be._dispatch_chunk() if r.be.pending else None
                if in_flight is None and nxt is None:
                    r.be.idle()
                    r.work.wait(timeout=0.5)
                    continue
            if in_flight is not None:
                with span("batch.wait"):  # unlocked
                    in_flight["toks"] = _host(in_flight["toks"])
                self._route(r, self._process(r, in_flight))
            in_flight = nxt
        if in_flight is not None:
            self._route(r, self._process(r, in_flight))

    def _loop_spec(self, r: _Replica):
        """Speculative rounds: each block's inputs depend on the previous
        block's acceptance, so rounds are synchronous, but only the
        dispatch and the routing hold the replica lock; the wait for the
        device result does not, so submits never wait on compute."""
        from llama_cu_awq_torch.engine.batch import _host
        from llama_cu_awq_torch.utils.profiling import span

        while True:
            with r.work:
                if not self._running:
                    break
                work = (r.be.dispatch_spec_round()
                        if r.be.pending else None)
                if work is None:
                    r.be.idle()
                    r.work.wait(timeout=0.5)
                    continue
            kind, payload = work
            if kind == "block":
                with span("batch.wait"):  # unlocked
                    payload["out"] = _host(payload["out"])
                with r.lock:
                    results = r.be._process_spec_block(payload)
            else:
                with span("batch.wait"):  # unlocked
                    payload["toks"] = _host(payload["toks"])
                results = self._process(r, payload)
            self._route(r, results)

    def _process(self, r: _Replica, chunk):
        # the scheduler mutates in _process_chunk (on_token) while handler
        # threads call submit and cancel: serialize under the replica lock
        with r.lock:
            return r.be._process_chunk(chunk)

    def _route(self, r: _Replica, results):
        for lrid, new_tokens, finished in results:
            rid = (r.idx, lrid)
            q = self._queues.get(rid)
            if q is None:
                continue
            if new_tokens:
                q.put(new_tokens)
                with self._qlock:
                    self.total_tokens += len(new_tokens)
            if finished:
                q.put(None)
                self._drop_rid(rid)
                # a long-running server must not keep every request
                with r.lock:
                    r.be.drop_request(lrid)

    # -- helpers ---------------------------------------------------------

    def stats(self) -> dict:
        per = []
        for r in self.replicas:
            with r.lock:
                per.append({"active_slots": r.be.scheduler.num_active,
                            "queued_requests": r.be.scheduler.num_queued,
                            "requests": r.served})
        out = {
            "uptime_s": round(time.time() - self.started_t, 1),
            "requests": self.total_requests,
            "generated_tokens": self.total_tokens,
            "active_slots": sum(p["active_slots"] for p in per),
            "queued_requests": sum(p["queued_requests"] for p in per),
            "rejected_requests": self.rejected_requests,
            "cancelled_requests": self.cancelled_requests,
            "max_queue": self.max_queue,
            "slots": sum(r.be.n_slots for r in self.replicas),
            "max_seq": self.be.max_seq,
        }
        if len(self.replicas) > 1:
            out["replicas"] = per
        return out


class _Handler(BaseHTTPRequestHandler):
    # class attributes set by make_server()
    engine: ServingEngine = None
    model_name: str = "llama"
    protocol_version = "HTTP/1.1"
    max_streams: int = 64           # concurrent SSE connections
    _streams = threading.Semaphore(64)

    def log_message(self, fmt, *args):
        get_logger("serve").debug(fmt % args)

    # -- GET -------------------------------------------------------------

    def do_GET(self):
        if self.path == "/health":
            self._json(200, {"status": "ok"})
        elif self.path == "/stats":
            self._json(200, self.engine.stats())
        elif self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [
                {"id": self.model_name, "object": "model",
                 "owned_by": "llama_cu_awq_torch"}]})
        else:
            self._json(404, {"error": "not found"})

    # -- POST ------------------------------------------------------------

    def do_POST(self):
        chat = self.path in ("/v1/chat/completions", "/chat/completions")
        if not chat and self.path not in ("/v1/completions", "/completions"):
            self._json(404, {"error": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            if chat:
                prompt = render_chat(req.get("messages", []))
            else:
                prompt = req.get("prompt", "")
            max_tokens = int(req.get("max_tokens", 128))
            stream = bool(req.get("stream", False))
            temperature = req.get("temperature")
            topp = req.get("top_p")
            if temperature is not None:
                temperature = float(temperature)
            if topp is not None:
                topp = float(topp)
            stop = req.get("stop")
            stops = ([stop] if isinstance(stop, str) else
                     list(stop) if stop is not None else [])
            if not all(isinstance(s, str) and s for s in stops) \
                    or len(stops) > 4:
                raise ValueError("stop must be a non-empty string or "
                                 "a list of up to 4 of them")
        except (ValueError, json.JSONDecodeError, TypeError) as e:
            self._json(400, {"error": f"bad request: {e}"})
            return

        eng = self.engine
        tok = eng.tokenizer
        stream_slot = False
        if stream:
            # bound concurrent SSE connections: each holds a handler
            # thread and a token queue for its whole generation
            stream_slot = self._streams.acquire(blocking=False)
            if not stream_slot:
                self._json(503, {"error": "too many concurrent streams",
                                 "max_streams": self.max_streams})
                return
        try:
            rid, q = eng.submit(prompt, max_new=max_tokens,
                                temperature=temperature, topp=topp)
        except ValueError as e:  # prompt too long for the KV cache
            if stream_slot:
                self._streams.release()
            self._json(400, {"error": str(e)})
            return
        except ServerOverloaded as e:
            if stream_slot:
                self._streams.release()
            self._json(429, {"error": str(e)})
            return
        cid = f"cmpl-{uuid.uuid4().hex[:24]}"

        prev = {"t": _last_prompt_token(tok, prompt)}

        def pieces(tokens):
            out = []
            for t in tokens:
                out.append(tok.safe_piece(tok.decode(prev["t"], t)))
                prev["t"] = t
            return "".join(out)

        def choice(text, reason):
            if chat:
                return {"index": 0, "delta": {"content": text},
                        "finish_reason": reason}
            return {"index": 0, "text": text, "finish_reason": reason}

        def find_stop(text):
            """Earliest stop-sequence hit in text, or -1."""
            hits = [h for h in (text.find(s) for s in stops) if h >= 0]
            return min(hits) if hits else -1

        obj = "chat.completion.chunk" if chat else "text_completion"
        if not stream:
            chunks, ids = [], []
            text = None
            while True:
                item = q.get()
                if item is None:
                    break
                ids.extend(item)
                chunks.append(pieces(item))
                if stops:
                    cut = find_stop("".join(chunks))
                    if cut >= 0:
                        # a stop sequence: truncate before it and free
                        # the slot (OpenAI `stop` semantics)
                        text = "".join(chunks)[:cut]
                        eng.cancel(rid)
                        break
            if text is None:
                text = "".join(chunks)
            n = len(ids)
            if chat:
                self._json(200, {
                    "id": cid, "object": "chat.completion",
                    "created": int(time.time()), "model": self.model_name,
                    "choices": [{"index": 0,
                                 "message": {"role": "assistant",
                                             "content": text},
                                 "finish_reason": "stop"}],
                    "usage": {"completion_tokens": n}})
            else:
                body = _completion_body(cid, self.model_name, text, n)
                body["choices"][0]["token_ids"] = ids  # extension field
                self._json(200, body)
            return

        # SSE streaming
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            # hold back a possible stop-sequence prefix, so a stop string
            # spanning two chunks is never partly emitted
            hold = max((len(s) for s in stops), default=1) - 1
            pending = ""

            def emit(text):
                if text:
                    self._sse(json.dumps({
                        "id": cid, "object": obj,
                        "choices": [choice(text, None)]}))

            def finish():
                self._sse(json.dumps({
                    "id": cid, "object": obj,
                    "choices": [choice("", "stop")]}))
                self._sse("[DONE]")

            while True:
                item = q.get()
                if item is None:
                    emit(pending)
                    finish()
                    break
                pending += pieces(item)
                cut = find_stop(pending) if stops else -1
                if cut >= 0:
                    emit(pending[:cut])
                    eng.cancel(rid)
                    finish()
                    break
                if hold and len(pending) > hold:
                    emit(pending[:-hold])
                    pending = pending[-hold:]
                elif not hold:
                    emit(pending)
                    pending = ""
            # end the chunked body (a keep-alive client would otherwise
            # wait on it forever) and close: one SSE response a connection
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            # the client went away mid-stream: free the slot
            eng.cancel(rid)
        finally:
            self.close_connection = True
            if stream_slot:
                self._streams.release()

    # -- wire helpers ----------------------------------------------------

    def _json(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _sse(self, data: str):
        payload = f"data: {data}\n\n".encode()
        self.wfile.write(f"{len(payload):x}\r\n".encode())
        self.wfile.write(payload + b"\r\n")
        self.wfile.flush()


def render_chat(messages) -> str:
    """OpenAI-style messages in the Llama-2 chat schema of the reference's
    chat mode (llama2_q4.cu:555-562): the system prompt joins the first
    user turn inside <<SYS>> tags, each (user, assistant) pair is
    `[INST] u [/INST] a`, and the prompt ends after the last user turn's
    [/INST]."""
    if not isinstance(messages, list):
        raise ValueError("messages must be a list")
    system = None
    turns = []  # (user_text, assistant_text | None)
    for m in messages:
        role, content = m.get("role"), m.get("content", "")
        if role == "system":
            system = content
        elif role == "user":
            turns.append([content, None])
        elif role == "assistant":
            if not turns or turns[-1][1] is not None:
                raise ValueError("assistant message without a user turn")
            turns[-1][1] = content
        else:
            raise ValueError(f"unknown role: {role!r}")
    if not turns or turns[-1][1] is not None:
        raise ValueError("conversation must end with a user message")
    parts = []
    for i, (user, assistant) in enumerate(turns):
        if i == 0 and system:
            user = f"<<SYS>>\n{system}\n<</SYS>>\n\n{user}"
        parts.append(f"[INST] {user} [/INST]")
        if assistant is not None:
            parts.append(f" {assistant} ")
    return "".join(parts)


def _last_prompt_token(tok, prompt) -> int:
    if isinstance(prompt, str):
        ids = tok.encode(prompt, bos=True, eos=False)
        return ids[-1] if ids else BOS_TOKEN
    return prompt[-1] if prompt else BOS_TOKEN


def _completion_body(cid, model, text, n_tokens):
    return {
        "id": cid,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0, "text": text, "finish_reason": "stop"}],
        "usage": {"completion_tokens": n_tokens},
    }


def make_server(batch_engine, tokenizer, host="0.0.0.0", port=8000,
                model_name="llama", max_queue: int = 256,
                max_streams: int = 64) -> tuple[ThreadingHTTPServer,
                                                ServingEngine]:
    """Build (http_server, serving_engine); the caller starts and stops
    both. batch_engine may be a list of BatchEngines (replicas)."""
    eng = ServingEngine(batch_engine, tokenizer, max_queue=max_queue)
    handler = type("BoundHandler", (_Handler,),
                   {"engine": eng, "model_name": model_name,
                    "max_streams": max_streams,
                    "_streams": threading.Semaphore(max_streams)})
    httpd = ThreadingHTTPServer((host, port), handler)
    return httpd, eng


def build_argparser():
    import argparse

    ap = argparse.ArgumentParser(
        prog="llama-torch-serve",
        description="OpenAI-style HTTP server over the continuous-"
                    "batching engine (PyTorch + CUDA)")
    ap.add_argument("checkpoint")
    ap.add_argument("-z", dest="tokenizer", default="tokenizer.bin")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--max-queue", type=int, default=256,
                    help="waiting-request bound; overflow gets HTTP 429")
    ap.add_argument("--max-streams", type=int, default=64,
                    help="concurrent SSE connection cap; overflow 503")
    ap.add_argument("--max-seq", type=int, default=None)
    ap.add_argument("-t", dest="temperature", type=float, default=0.5)
    ap.add_argument("-p", dest="topp", type=float, default=0.6)
    ap.add_argument("-s", dest="seed", type=int, default=0)
    ap.add_argument("--chunk-size", type=int, default=8)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--kv-bits", type=int, default=8, choices=[8, 4],
                    help="quantized-KV width; 4 = two codes a byte "
                         "(implies --kv-quant)")
    ap.add_argument("--spec", default="ngram", choices=["ngram", "none"],
                    help="speculative serving blocks with prompt-lookup "
                         "proposals (the same streams as plain decode; an "
                         "adaptive throttle pauses proposals where they "
                         "stop paying). 'none' disables")
    ap.add_argument("--spec-k", type=int, default=7)
    ap.add_argument("--prefix-cache", type=int, default=0, metavar="N",
                    help="keep the KV rows of up to N prompt prefixes "
                         "(block-multiple lengths) for admission by copy")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel over M ranks a replica, one "
                         "process and (with --device cuda) one card each")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel replicas: one BatchEngine per group "
                         "of --tp cards (replica r on cuda:r*M..r*M+M-1), "
                         "requests routed to the least-loaded replica")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the card (default) or the CPU")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.seed <= 0:
        args.seed = int(time.time())

    import torch

    from llama_cu_awq_torch.device import resolve_device
    from llama_cu_awq_torch.io.checkpoint import load_checkpoint
    from llama_cu_awq_torch.tokenizer import Tokenizer

    resolve_device(args.device)
    need = args.dp * args.tp
    if args.device == "cuda":
        have = torch.cuda.device_count()
        if need > have:
            raise SystemExit(f"--dp {args.dp} x --tp {args.tp} needs "
                             f"{need} cards, have {have}")
    ckpt = load_checkpoint(args.checkpoint, verbose=True)
    tokenizer = Tokenizer(args.tokenizer, ckpt.config.vocab_size)
    if args.tp == 1:
        devices = ([f"cuda:{i}" for i in range(args.dp)]
                   if args.device == "cuda" else ["cpu"] * args.dp)
        return _serve(args, [_engine(args, ckpt, tokenizer, dev, seed=i)
                             for i, dev in enumerate(devices)], tokenizer)
    return run_replicas(args, ckpt, tokenizer,
                        lambda engines: _serve(args, engines, tokenizer))


def run_replicas(args, ckpt, tokenizer, body, devices=None,
                 backend=None, timeout=None) -> int:
    """Serve `--dp N --tp M` (M > 1) through body(engines): this process
    is global rank 0 and builds the N replicas' leader engines (shard 0
    of each, parallel/mesh.py make_replica_groups); it spawns ranks 1 ..
    N*(M-1) (parallel/multihost.py run_ranks), each of which builds its
    replica's shard and follows that replica's leader. When body returns,
    every leader stops its followers. Returns 0 where body and every
    rank returned or exited with 0 (multihost.run_ranks).

    devices: N*M devices, replica r's shard c at r*M + c (default: cuda:
    r*M + c, or the CPU with --device cpu); backend: "nccl" by default
    with --device cuda (a card per rank; rank 0 then drives N cards over
    NCCL, untried: every card run of this path had one card), else
    "gloo" (the CPU, or ranks sharing one card); timeout: each rank's
    wait on the others, a datetime.timedelta (torch.distributed's default
    where None)."""
    import torch

    from llama_cu_awq_torch.parallel.mesh import default_replica_devices
    from llama_cu_awq_torch.parallel.multihost import run_ranks
    from llama_cu_awq_torch.parallel.tp import _check_divisible

    _check_divisible(ckpt.config, args.tp)  # before any rank starts
    if backend is None:
        backend = "nccl" if args.device == "cuda" else "gloo"
    if devices is None:
        devices = default_replica_devices(args.dp, args.tp, backend)

    def leader(init):
        engines = _replica_engines(args, ckpt, tokenizer, 0, init, backend,
                                   devices, timeout)
        try:
            return body([engines[r] for r in range(args.dp)])
        finally:
            for be in engines.values():
                be.stop_followers()
            torch.distributed.destroy_process_group()

    return run_ranks(1 + args.dp * (args.tp - 1), leader, _replica_follower,
                     (args, backend, devices, timeout))


def _engine(args, ckpt, tokenizer, device, seed: int = 0, params=None,
            tp=None):
    """One replica's BatchEngine. Its params at --tp 1: the checkpoint's
    fp16 embed and head (param_dtype None), as the JAX server's
    (llama_cu_awq_tpu/serve.py:641); an fp16 head takes the plain f32
    product (ops/linear.py dense_matmul)."""
    from llama_cu_awq_torch.engine import BatchEngine
    from llama_cu_awq_torch.models import params_from_checkpoint

    if params is None:
        params = params_from_checkpoint(ckpt, device=device, param_dtype=None)
    return BatchEngine(
        params, ckpt.config, tokenizer, n_slots=args.slots,
        max_seq=args.max_seq, temperature=args.temperature,
        topp=args.topp, seed=args.seed + seed,
        kv_quant=(4 if args.kv_bits == 4 else args.kv_quant),
        spec=None if args.spec == "none" else args.spec,
        spec_k=args.spec_k, prefix_cache_size=args.prefix_cache,
        chunk_size=args.chunk_size, device=device, tp=tp)


def _replica_engines(args, ckpt, tokenizer, rank: int, init: str,
                     backend: str, devices, timeout=None) -> dict:
    """Global rank `rank`'s BatchEngines under --tp, by replica: it joins
    the world and the replicas' groups and builds its shard of each
    replica it is in (rank 0: shard 0 of every one), with
    tp_params_from_checkpoint's default bf16 embed and head (the JAX
    server's, llama_cu_awq_tpu/serve.py:639). Replica r's seed is
    args.seed + r (the JAX server's seed=args.seed + i)."""
    import torch

    from llama_cu_awq_torch.parallel import (init_multihost,
                                             make_replica_groups,
                                             replica_shard)
    from llama_cu_awq_torch.parallel.tp import tp_params_from_checkpoint

    r, c = replica_shard(rank, args.tp) if rank else (0, 0)
    first = torch.device(devices[r * args.tp + c])
    if first.type == "cuda":
        torch.cuda.set_device(first)
    init_multihost(init, 1 + args.dp * (args.tp - 1), rank, backend=backend,
                   timeout=timeout)
    groups = make_replica_groups(args.dp, args.tp, devices)
    return {r: _engine(args, ckpt, tokenizer, tp.device, seed=r, tp=tp,
                       params=tp_params_from_checkpoint(
                           ckpt, args.tp, tp.rank, device=tp.device))
            for r, tp in groups.items()}


def _replica_follower(rank: int, n: int, init: str, args, backend: str,
                      devices, timeout=None) -> None:
    """Global rank 1..n-1 under --tp (a spawned process): its engine
    follows its replica's leader until the leader stops it."""
    import signal

    import torch

    from llama_cu_awq_torch.io.checkpoint import load_checkpoint
    from llama_cu_awq_torch.tokenizer import Tokenizer

    # rank 0 takes the interrupt and stops this rank (stop_followers)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    ckpt = load_checkpoint(args.checkpoint)
    engines = _replica_engines(
        args, ckpt, Tokenizer(args.tokenizer, ckpt.config.vocab_size), rank,
        init, backend, devices, timeout)
    (be,) = engines.values()
    be.follow()
    torch.distributed.destroy_process_group()


def _serve(args, engines, tokenizer) -> int:
    """Serve the replicas until interrupted."""
    log = get_logger("serve")
    httpd, eng = make_server(engines if args.dp > 1 else engines[0],
                             tokenizer, args.host, args.port,
                             max_queue=args.max_queue,
                             max_streams=args.max_streams)
    eng.start()
    log.info("serving on %s:%d (%d slots x %d replicas, max_seq %d%s)",
             args.host, httpd.server_address[1], args.slots, args.dp,
             engines[0].max_seq,
             f", {args.tp} tensor-parallel ranks a replica"
             if args.tp > 1 else "")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        eng.stop()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
