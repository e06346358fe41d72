"""Continuous-batching slot scheduler (the counterpart of
llama_cu_awq_tpu/engine/scheduler.py).

Two interchangeable implementations with identical semantics:

  - NativeScheduler: ctypes bindings over the C++ scheduler
    (native/batch_scheduler.cpp at the repository root), compiled with g++
    on first use into build/llama_cu_awq_torch/, the directory the CUDA
    kernels build into;
  - PyScheduler: pure-Python fallback and test oracle.

`make_scheduler()` picks the native one when g++ and the source are
there. Semantics (see the C++ header comment): FCFS queue, a fixed pool of
KV slots, per-request max-new-tokens budget, finish on EOS / budget /
sequence capacity, slots freed between decode steps. This is host-side
bookkeeping between decode chunks; nothing of it runs on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import deque
from dataclasses import dataclass

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "batch_scheduler.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "llama_cu_awq_torch")
_GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


@dataclass
class Request:
    id: int
    prompt_len: int
    max_new: int  # <=0: unlimited (clamped by max_seq)


class PyScheduler:
    """Reference implementation (same transitions as the C++ one)."""

    def __init__(self, n_slots: int, max_seq: int):
        assert n_slots > 0 and max_seq > 1
        self.max_seq = max_seq
        self._slots: list[Request | None] = [None] * n_slots
        self._generated = [0] * n_slots
        self._queue: deque[Request] = deque()
        self.finished = 0

    def add(self, request_id: int, prompt_len: int, max_new: int = 0) -> bool:
        if prompt_len < 1 or prompt_len + 1 > self.max_seq:
            return False
        self._queue.append(Request(request_id, prompt_len, max_new))
        return True

    def admit(self) -> list[tuple[int, int]]:
        out = []
        for s in range(len(self._slots)):
            if not self._queue:
                break
            if self._slots[s] is None:
                self._slots[s] = self._queue.popleft()
                self._generated[s] = 0
                out.append((s, self._slots[s].id))
        return out

    def on_token(self, slot: int, is_eos: bool) -> bool:
        """True when the slot's request finished with this token."""
        req = self._slots[slot]
        assert req is not None, f"slot {slot} is free"
        self._generated[slot] += 1
        pos = req.prompt_len + self._generated[slot]
        done = (is_eos
                or (req.max_new > 0 and self._generated[slot] >= req.max_new)
                or pos >= self.max_seq)
        if done:
            self._slots[slot] = None
            self.finished += 1
        return done

    def cancel(self, request_id: int) -> int:
        """Cancel wherever the request lives. Returns the slot it
        occupied, -2 if it was still queued, -1 if unknown/finished."""
        for s, req in enumerate(self._slots):
            if req is not None and req.id == request_id:
                self._slots[s] = None
                self.finished += 1
                return s
        for i, req in enumerate(self._queue):
            if req.id == request_id:
                del self._queue[i]
                self.finished += 1
                return -2
        return -1

    def slot_request(self, slot: int) -> int:
        req = self._slots[slot]
        return -1 if req is None else req.id

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def num_queued(self) -> int:
        return len(self._queue)


def _find_or_build_lib() -> str | None:
    """The native scheduler library, built with g++ when missing; None
    without g++ or without the source. The file name carries a hash of
    the source and the flags, so an edited source rebuilds; concurrent
    builders each write their own temporary file and rename it."""
    gxx = shutil.which("g++")
    if gxx is None or not os.path.exists(_SRC):
        return None
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_GXX_FLAGS).encode())
    lib = os.path.join(BUILD_DIR,
                       f"libbatch_scheduler-{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run([gxx, *_GXX_FLAGS, "-o", tmp, _SRC], check=True)
        os.replace(tmp, lib)
    return lib


class NativeScheduler:
    """ctypes bindings over native/batch_scheduler.cpp (C ABI)."""

    def __init__(self, n_slots: int, max_seq: int, lib_path: str):
        lib = ctypes.CDLL(lib_path)
        lib.bs_create.restype = ctypes.c_void_p
        lib.bs_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.bs_destroy.argtypes = [ctypes.c_void_p]
        lib.bs_add.restype = ctypes.c_int
        lib.bs_add.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int, ctypes.c_int]
        lib.bs_admit.restype = ctypes.c_int
        lib.bs_admit.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_int32),
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.c_int]
        lib.bs_on_token.restype = ctypes.c_int
        lib.bs_on_token.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
        lib.bs_cancel.restype = ctypes.c_int
        lib.bs_cancel.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        for name in ("bs_num_active", "bs_num_queued"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.bs_num_finished.restype = ctypes.c_int64
        lib.bs_num_finished.argtypes = [ctypes.c_void_p]
        lib.bs_slot_request.restype = ctypes.c_int64
        lib.bs_slot_request.argtypes = [ctypes.c_void_p, ctypes.c_int]
        self._lib = lib
        self._n_slots = n_slots
        self.max_seq = max_seq
        self._h = lib.bs_create(n_slots, max_seq)
        if not self._h:
            raise ValueError(f"bad scheduler params {n_slots=} {max_seq=}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bs_destroy(self._h)
            self._h = None

    def add(self, request_id: int, prompt_len: int, max_new: int = 0) -> bool:
        return self._lib.bs_add(self._h, request_id, prompt_len,
                                max_new) == 0

    def admit(self) -> list[tuple[int, int]]:
        slots = (ctypes.c_int32 * self._n_slots)()
        ids = (ctypes.c_int64 * self._n_slots)()
        n = self._lib.bs_admit(self._h, slots, ids, self._n_slots)
        return [(int(slots[i]), int(ids[i])) for i in range(n)]

    def on_token(self, slot: int, is_eos: bool) -> bool:
        r = self._lib.bs_on_token(self._h, slot, int(is_eos))
        assert r >= 0, f"slot {slot} is free"
        return r == 1

    def cancel(self, request_id: int) -> int:
        return self._lib.bs_cancel(self._h, request_id)

    def slot_request(self, slot: int) -> int:
        return int(self._lib.bs_slot_request(self._h, slot))

    @property
    def num_active(self) -> int:
        return self._lib.bs_num_active(self._h)

    @property
    def num_queued(self) -> int:
        return self._lib.bs_num_queued(self._h)

    @property
    def finished(self) -> int:
        return int(self._lib.bs_num_finished(self._h))


def make_scheduler(n_slots: int, max_seq: int, prefer_native: bool = True):
    if prefer_native:
        try:
            lib = _find_or_build_lib()
        except subprocess.CalledProcessError:
            lib = None
        if lib is not None:
            return NativeScheduler(n_slots, max_seq, lib)
    return PyScheduler(n_slots, max_seq)
