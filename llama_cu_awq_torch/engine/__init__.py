from llama_cu_awq_torch.engine.engine import InferenceEngine, attn_buckets

__all__ = ["InferenceEngine", "attn_buckets"]
