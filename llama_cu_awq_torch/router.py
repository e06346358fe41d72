"""Request router: one HTTP front end over N serving processes.

The counterpart of llama_cu_awq_tpu/router.py, stdlib only. Every host (or
card group) runs its own `llama_cu_awq_torch.serve` process; KV slots
never leave their process, and this one balances requests across them.

- Least-loaded routing on locally tracked in-flight counts, the policy
  ServingEngine uses across replicas in one process (serve.py:_Replica).
  Backend /stats is not polled per request: a local counter is exact for
  the requests this router started.
- Failover: a backend that refuses connections or times out is marked
  down and retried after `retry_s`; a 429 or 503 (admission queue full,
  stream cap) from one backend falls through to the next least-loaded
  one. The client sees an error only when every backend is down or full.
- Streaming pass-through: SSE bytes are re-chunked to the client as they
  arrive from the backend, so time to first token survives the hop.

Run:  python -m llama_cu_awq_torch.router \
          --backends http://host-a:8000,http://host-b:8000 --port 8100
"""

from __future__ import annotations

import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from llama_cu_awq_torch.utils.logging import get_logger


class _ClientGone(Exception):
    """The ROUTER'S CLIENT disconnected mid-relay. Distinguished from
    backend failures so the handler neither marks the (healthy) backend
    down nor replays the whole request at another backend just to fail
    writing to the same dead client."""


def _probe_tcp(base: str, timeout: float = 3.0) -> None:
    """Fast TCP reachability check before the real request: a
    black-holed host (powered off, firewalled DROP) would otherwise
    stall urlopen's connect for minutes before failover. Raises OSError
    (the caller's mark-down path) when unreachable."""
    u = urllib.parse.urlparse(base)
    port = u.port or (443 if u.scheme == "https" else 80)
    with socket.create_connection((u.hostname, port), timeout=timeout):
        pass


class _Backend:
    def __init__(self, base: str, idx: int):
        self.base = base.rstrip("/")
        self.idx = idx
        self.inflight = 0
        self.down_until = 0.0     # monotonic time; 0 = healthy
        self.served = 0
        self.errors = 0


class Router:
    """Pick-backend + bookkeeping; transport lives in the handler."""

    def __init__(self, backends: list[str], retry_s: float = 5.0):
        if not backends:
            raise ValueError("router needs at least one backend")
        self.backends = [_Backend(b, i) for i, b in enumerate(backends)]
        self.retry_s = retry_s
        self._lock = threading.Lock()

    def candidates(self) -> list[_Backend]:
        """Healthy backends, least-loaded first, then down ones as a
        last resort (their retry window may have just expired — and a
        router with every backend marked down must still probe)."""
        now = time.monotonic()
        with self._lock:
            up = [b for b in self.backends if b.down_until <= now]
            down = [b for b in self.backends if b.down_until > now]
        up.sort(key=lambda b: (b.inflight, b.idx))
        down.sort(key=lambda b: b.down_until)
        return up + down

    def acquire(self, b: _Backend):
        with self._lock:
            b.inflight += 1

    def release(self, b: _Backend, ok: bool):
        with self._lock:
            b.inflight -= 1
            if ok:
                b.served += 1
                b.down_until = 0.0

    def mark_down(self, b: _Backend):
        with self._lock:
            b.errors += 1
            b.down_until = time.monotonic() + self.retry_s

    def stats(self) -> dict:
        """Aggregate of live backend /stats plus router-side counters.
        Backends currently marked down are reported from router state
        only — probing them serially would stall the aggregate call."""
        per = []
        for b in self.backends:
            up = b.down_until <= time.monotonic()
            row = {"backend": b.base, "inflight": b.inflight,
                   "served": b.served, "errors": b.errors, "up": up}
            if up:
                try:
                    with urllib.request.urlopen(b.base + "/stats",
                                                timeout=5) as r:
                        row["stats"] = json.loads(r.read())
                except (urllib.error.URLError, OSError, ValueError):
                    row["up"] = False
            per.append(row)
        return {"backends": per,
                "slots": sum(p["stats"].get("slots", 0)
                             for p in per if "stats" in p)}


class _RouterHandler(BaseHTTPRequestHandler):
    router: Router = None
    protocol_version = "HTTP/1.1"
    # POST paths forwarded verbatim; everything the serving API accepts
    FORWARD = ("/v1/completions", "/completions",
               "/v1/chat/completions", "/chat/completions")

    def log_message(self, fmt, *args):
        get_logger("router").debug(fmt % args)

    # -- GET --------------------------------------------------------

    def do_GET(self):
        if self.path == "/health":
            up = any(b.down_until <= time.monotonic()
                     for b in self.router.backends)
            self._json(200 if up else 503,
                       {"status": "ok" if up else "all backends down"})
        elif self.path == "/stats":
            self._json(200, self.router.stats())
        elif self.path == "/v1/models":
            for b in self.router.candidates():
                try:
                    with urllib.request.urlopen(b.base + "/v1/models",
                                                timeout=10) as r:
                        body = r.read()
                    self._raw(200, "application/json", body)
                    return
                except (urllib.error.URLError, OSError,
                        http.client.HTTPException):
                    self.router.mark_down(b)
            self._json(503, {"error": "all backends down"})
        else:
            self._json(404, {"error": "not found"})

    # -- POST -------------------------------------------------------

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)  # always drain: keep-alive sync
        if self.path not in self.FORWARD:
            self._json(404, {"error": "not found"})
            return
        last_err = (503, {"error": "all backends down"})
        for b in self.router.candidates():
            self.router.acquire(b)
            self._relay_started = False  # bytes sent to the client?
            self._released = False       # b released for this request?
            try:
                _probe_tcp(b.base)  # fast-fail black-holed hosts
                req = urllib.request.Request(
                    b.base + self.path, data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=600) as resp:
                    self._relay(resp, b)  # releases b, ok=True
                return
            except urllib.error.HTTPError as e:
                # backend answered: 4xx/5xx. 429/503 = that backend is
                # full — try the next one (release ok=False: refused,
                # not served); anything else (e.g. 400 bad request) is
                # the client's answer, not a routing issue.
                payload = e.read()
                if e.code not in (429, 503):
                    self._release(b, ok=True)
                    self._raw(e.code, "application/json", payload)
                    return
                self._release(b, ok=False)
                try:
                    last_err = (e.code, json.loads(payload))
                except ValueError:
                    last_err = (e.code, {"error": "backend full"})
            except _ClientGone:
                # the CLIENT died mid-relay: the backend is healthy —
                # do not mark it down, do not replay the request, and
                # do not write anything more to this connection
                self._release(b, ok=True)
                self.close_connection = True
                return
            except (urllib.error.URLError, OSError,
                    http.client.HTTPException):
                self._release(b, ok=False)
                self.router.mark_down(b)
                if self._relay_started:
                    # headers/partial body already went out: a retry
                    # or error JSON would interleave a second response
                    # into the stream — terminate the connection and
                    # let the client's SSE parser see the truncation
                    self.close_connection = True
                    return
        self._json(*last_err)

    def _release(self, b: _Backend, ok: bool):
        """Release b for this request once: _relay counts a served
        request before the last bytes go out, and a later failure of
        the same request must not release it again."""
        if not self._released:
            self._released = True
            self.router.release(b, ok=ok)

    def _relay(self, resp, b: _Backend):
        """Stream a backend response through: SSE re-chunked as bytes
        arrive (time-to-first-token survives the hop), plain JSON sent
        with Content-Length. Sets self._relay_started once any bytes
        have been written to the client (the caller must not write a
        second response after that). Client-side write failures raise
        _ClientGone so the caller never confuses them with a backend
        failure (which would trigger mark-down + replay). Once the
        backend's answer is whole, b is released as served before the
        client's last bytes are written, so a client that reads /stats
        after its answer sees its request counted."""
        ctype = resp.headers.get("Content-Type", "application/json")
        if "text/event-stream" not in ctype:
            payload = resp.read()  # backend read OUTSIDE client writes
            self._release(b, ok=True)
            self._relay_started = True
            try:
                self._raw(resp.status, ctype, payload)
            except OSError as e:
                raise _ClientGone from e
            return
        while True:
            # backend read FIRST: if it fails before any client write,
            # _relay_started is still False and failover stays clean
            chunk = resp.read1(65536)
            try:
                if not self._relay_started:
                    self.send_response(resp.status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    self._relay_started = True
                if not chunk:
                    self._release(b, ok=True)
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                    self.close_connection = True
                    return
                self.wfile.write(b"%x\r\n" % len(chunk) + chunk
                                 + b"\r\n")
                self.wfile.flush()
            except OSError as e:
                raise _ClientGone from e

    # -- helpers ------------------------------------------------------

    def _raw(self, code: int, ctype: str, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj: dict):
        self._raw(code, "application/json",
                  json.dumps(obj).encode())


def make_router(backends: list[str], host: str = "0.0.0.0",
                port: int = 8100, retry_s: float = 5.0):
    """Build (httpd, router); caller runs httpd.serve_forever()."""
    router = Router(backends, retry_s=retry_s)
    handler = type("BoundRouterHandler", (_RouterHandler,),
                   {"router": router})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    return httpd, router


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Route OpenAI-style requests across serving hosts")
    ap.add_argument("--backends", required=True,
                    help="comma-separated base URLs of serve processes")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8100)
    ap.add_argument("--retry-s", type=float, default=5.0,
                    help="down-backend retry window (seconds)")
    args = ap.parse_args(argv)
    httpd, _ = make_router([b for b in args.backends.split(",") if b],
                           host=args.host, port=args.port,
                           retry_s=args.retry_s)
    print(f"router on {args.host}:{httpd.server_address[1]} -> "
          f"{args.backends}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
