from llama_cu_awq_torch.models.llama import (
    KVCache,
    LlamaParams,
    forward,
    init_kv_cache,
    kv_cache_from_numpy,
    params_from_checkpoint,
    params_from_numpy,
    quantize_lm_head,
    synthetic_params,
)

__all__ = [
    "KVCache",
    "LlamaParams",
    "forward",
    "init_kv_cache",
    "kv_cache_from_numpy",
    "params_from_checkpoint",
    "params_from_numpy",
    "quantize_lm_head",
    "synthetic_params",
]
