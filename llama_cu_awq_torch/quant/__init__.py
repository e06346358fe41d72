from llama_cu_awq_torch.quant.packing import dequantize_np, quantize_np
from llama_cu_awq_torch.quant.qtensor import QTensor

__all__ = ["dequantize_np", "quantize_np", "QTensor"]
