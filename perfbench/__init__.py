"""The benchmark of llama_cu_awq_torch on one NVIDIA H100: see run.py."""
