"""Continuous batching (the counterpart of llama_cu_awq_tpu/engine/batch.py).

Not ported yet: the slot KV cache, chunked prefill, prefix cache and the
serving layer on top of them come with batched_decode_attention in a
later slice (ROADMAP.md, queue 1).
"""

from __future__ import annotations


class BatchEngine:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "BatchEngine (continuous batching) and serving are not ported "
            "yet; InferenceEngine runs batch-1 generate and chat")
