"""The offline AWQ tools: convert_awq_to_bin (stage 1) and pack_weights
(stage 2), run with `python -m llama_cu_awq_torch.tools.<name>`."""
