from llama_cu_awq_torch.engine.batch import BatchEngine
from llama_cu_awq_torch.engine.engine import InferenceEngine, attn_buckets

__all__ = ["BatchEngine", "InferenceEngine", "attn_buckets"]
