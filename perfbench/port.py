"""Every place where the benchmark touches llama_cu_awq_torch.

The benchmark drives the program through its engines' public calls
(InferenceEngine.generate_benchmark, BatchEngine.submit/step and the
scheduler's num_active), reads its launch counters
(llama_cu_awq_torch.ops.cuda LAUNCHES and VARIANT_LAUNCHES, which CUDA
graph replays keep true) and hands it the run's weight tensors. It reads
the engines' block width and forced-prompt threshold only to know which
shapes a mix will ask for, so that set-up warms them.
"""

from __future__ import annotations

import importlib

from perfbench.weights import Weights


def program():
    """The program's modules, imported on first use."""
    names = ("config", "models.llama", "quant.qtensor", "engine.engine",
             "engine.batch", "ops.cuda", "ops.norms")
    return {n: importlib.import_module(f"llama_cu_awq_torch.{n}")
            for n in names}


def model_config(w: Weights):
    s = w.shape
    cfg = program()["config"].ModelConfig(
        dim=s.dim, hidden_dim=s.hidden, n_layers=s.layers, n_heads=s.heads,
        n_kv_heads=s.kv_heads, vocab_size=s.vocab, seq_len=s.max_positions,
        rope_theta=s.rope_theta)
    eps = program()["ops.norms"].RMS_EPS
    if abs(eps - s.eps) > 1e-12:
        raise ValueError(f"the program's rmsnorm eps is {eps}, the "
                         f"configuration states {s.eps}")
    return cfg


def params(w: Weights):
    """The program's LlamaParams over the run's tensors (no copies)."""
    m = program()
    QTensor = m["quant.qtensor"].QTensor
    llama = m["models.llama"]

    def q(name, l):
        p = w.proj[name]
        return QTensor(p.qw[l], p.scales[l], p.zeros[l], p.n_in, p.n_out)

    layers = [llama.LlamaLayer(attn_norm=w.norms[l, 0],
                               ffn_norm=w.norms[l, 1],
                               wqkv=q("wqkv", l), wo=q("wo", l),
                               w_gate_up=q("w_gate_up", l),
                               w_down=q("w_down", l))
              for l in range(w.shape.layers)]
    return llama.LlamaParams(w.embed, w.head, w.final_norm, layers)


def sequence_engine(w: Weights, mix: dict, device):
    return program()["engine.engine"].InferenceEngine(
        params(w), model_config(w), None, max_seq=mix["max_seq"],
        temperature=0.0, chunk_size=mix["chunk"], device=device)


def batch_engine(w: Weights, mix: dict, seed: int, device):
    return program()["engine.batch"].BatchEngine(
        params(w), model_config(w), None, n_slots=mix["slots"],
        max_seq=mix["max_seq"], chunk_size=mix["chunk"],
        temperature=float(mix["temperature"]), topp=float(mix["top_p"]),
        seed=int(seed) % (1 << 63) + 1, device=device)


def block() -> int:
    """The engines' prompt block width."""
    return program()["engine.engine"].PREFILL_BLOCK


def forced_prompt_max() -> int:
    """The longest prompt the batch engine feeds through its decode
    steps."""
    return program()["engine.batch"].BatchEngine.FORCED_PROMPT_MAX


def buckets(max_seq: int) -> list[int]:
    """The attention windows the engines replay their graphs at."""
    return program()["engine.engine"].attn_buckets(max_seq)


def launches() -> tuple[dict, dict]:
    """The launch counters as they stand: per kernel, per variant."""
    c = program()["ops.cuda"]
    return dict(c.LAUNCHES), dict(c.VARIANT_LAUNCHES)


def graphs_held(engine) -> int | None:
    """How many CUDA graphs the engine holds, where it says (a diagnostic
    of warm-up; None where the engine has no such record)."""
    gs = getattr(engine, "_graphs", None)
    return len(gs.graphs) if gs is not None and hasattr(gs, "graphs") \
        else None


def prebuild() -> None:
    """Build the program's CUDA libraries that are missing, all at once
    (on the card; a no-op without one or where the program has no such
    call)."""
    import torch
    if not torch.cuda.is_available():
        return
    build = importlib.import_module("llama_cu_awq_torch.ops.cuda._build")
    if hasattr(build, "build_all"):
        build.build_all()
