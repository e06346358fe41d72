"""Whole runs on the CPU, past the look for a card, at a tiny size.

tiny.make_root adds a cell the way a later change would (a configuration,
a mix, a limit and BENCHMARK.json entries, no edit to a file that is
there). A run of it comes out correct; a run with the timed path broken
underneath comes out not correct, for each fault a serving cell can
have: a step that leaves its state unchanged (no cache row written), a
token altered where it is produced, and half of the batch left out (the
other half's rows served in their place); and the fp8 control fails the
limit that the program passes."""

import pytest
import torch

from perfbench import run
from perfbench.tests import tiny

CELLS = ["tiny.tiny_seq", "tiny.tiny_batch"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return tiny.make_root(tmp_path_factory.mktemp("perfbench"))


def one(root, cell, trace=0, seed=2**31 + 17):
    code, res = run.run(tiny.Args(cell, seed=seed, trace=trace),
                        device="cpu", root=root)
    assert code == 0
    return res


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cell_runs_correct(root, cell, trace):
    res = one(root, cell, trace)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    names = set(res["metrics"])
    b1 = cell.endswith("seq")
    if trace:
        # the CPU launches no kernel; the added metric reads the rows
        assert names == ({"device_idle_share.b1", "tiny_rows.b1"} if b1
                         else {"device_idle_share", "tiny_rows",
                               "slots_active_mean"})
    else:
        assert names == ({"b1_tok_s", "setup_s"} if b1 else
                         {"output_tok_s", "ttft_p95_ms", "tpot_p95_ms",
                          "setup_s"})


def _token_altered(monkeypatch):
    from llama_cu_awq_torch.engine import batch, engine
    for mod, name in ((engine, "sample_token"), (batch, "sample_token"),
                      (batch, "sample_token_vec")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k:
                            (_r(*a, **k) + 1) % tiny.TINY["vocab_size"])


def _state_unchanged(monkeypatch):
    from llama_cu_awq_torch.models import llama
    monkeypatch.setattr(llama, "_update_cache", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from llama_cu_awq_torch.engine import batch
    real = batch.forward

    def forward(*a, **k):
        logits, cache = real(*a, **k)
        if logits is not None and logits.shape[0] > 1:
            logits = logits.clone()
            logits[1::2] = logits[0::2][:logits[1::2].shape[0]]
        return logits, cache
    monkeypatch.setattr(batch, "forward", forward)


FAULTS = {"state_unchanged": (_state_unchanged, CELLS),
          "token_altered": (_token_altered, CELLS),
          "half_batch": (_half_batch, ["tiny.tiny_batch"])}


@pytest.mark.parametrize("fault,cell", [(f, c) for f, (_, cs) in
                                        FAULTS.items() for c in cs])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, fault, cell):
    FAULTS[fault][0](monkeypatch)
    res = one(root, cell)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_fails_the_limit(root, cell):
    from perfbench import control
    r = control.reading(root, cell, 2**31 + 5, 1.5, True, device="cpu")
    assert r["widest_gap"] <= tiny.LIMIT < r["control_gap"], r
