"""The port's slot scheduler against the JAX package's, on random traces.

Both of the port's implementations (the Python one and the ctypes binding
over native/batch_scheduler.cpp, built into build/llama_cu_awq_torch/)
are driven with the same random workload as the JAX package's
PyScheduler: every admission, finish and cancel must agree step for step.
"""

import os

import numpy as np
import pytest

from llama_cu_awq_torch.engine import scheduler as ts
from llama_cu_awq_tpu.engine.scheduler import PyScheduler as JPyScheduler


def _port(impl, n_slots, max_seq):
    if impl == "py":
        return ts.PyScheduler(n_slots, max_seq)
    lib = ts._find_or_build_lib()
    if lib is None:
        pytest.skip("no g++ for the native scheduler")
    return ts.NativeScheduler(n_slots, max_seq, lib)


@pytest.mark.parametrize("impl", ["py", "native"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_jax_on_random_trace(impl, seed):
    """Adds (some oversized or empty), admissions, tokens with EOS and
    budgets, and cancels of live, queued, finished and unknown ids."""
    rng = np.random.default_rng(seed)
    n_slots, max_seq = 3 + seed, 24 + 8 * seed
    want = JPyScheduler(n_slots, max_seq)
    got = _port(impl, n_slots, max_seq)
    next_id = 0
    for _ in range(400):
        op = rng.random()
        if op < 0.3:
            plen = int(rng.integers(0, max_seq + 2))
            mnew = int(rng.integers(0, 6))
            assert got.add(next_id, plen, mnew) == want.add(next_id, plen,
                                                            mnew)
            next_id += 1
        elif op < 0.45:
            assert got.admit() == want.admit()
        elif op < 0.55 and next_id:
            rid = int(rng.integers(0, next_id + 2))
            assert got.cancel(rid) == want.cancel(rid)
        else:
            slot = int(rng.integers(0, n_slots))
            if want.slot_request(slot) != -1:
                eos = bool(rng.random() < 0.15)
                assert got.on_token(slot, eos) == want.on_token(slot, eos)
        assert (got.num_active, got.num_queued, got.finished) == \
               (want.num_active, want.num_queued, want.finished)
        for slot in range(n_slots):
            assert got.slot_request(slot) == want.slot_request(slot)


def test_make_scheduler_builds_native_into_the_build_dir():
    s = ts.make_scheduler(2, 16)
    if isinstance(s, ts.PyScheduler):
        assert ts._find_or_build_lib() is None  # no g++ here
        return
    assert isinstance(s, ts.NativeScheduler)
    lib = ts._find_or_build_lib()
    assert os.path.dirname(lib) == ts.BUILD_DIR
    assert ts.BUILD_DIR.endswith(os.path.join("build", "llama_cu_awq_torch"))
    assert isinstance(ts.make_scheduler(2, 16, prefer_native=False),
                      ts.PyScheduler)
