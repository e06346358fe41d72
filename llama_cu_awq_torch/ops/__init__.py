from llama_cu_awq_torch.ops.linear import dense_matmul, qmatmul, qmatmul_fused
from llama_cu_awq_torch.ops.norms import rmsnorm
from llama_cu_awq_torch.ops.rope import apply_rope

__all__ = ["dense_matmul", "qmatmul", "qmatmul_fused", "rmsnorm",
           "apply_rope"]
