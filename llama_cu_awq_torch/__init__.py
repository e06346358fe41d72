"""INT4 AWQ Llama-2 inference engine in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The port of llama_cu_awq_tpu (the JAX/Pallas package beside it, which
stays the reference): the same `.bin` checkpoint format, tokenizer,
sampler and generate/chat modes; w4-g128 dequant GEMVs, the lm_head GEMV
and the decode attention step run as CUDA kernels built from csrc/.
Imports torch and numpy, never jax.
"""

from llama_cu_awq_torch.config import ModelConfig

__version__ = "0.1.0"

__all__ = ["ModelConfig", "__version__"]
