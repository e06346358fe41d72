"""The port's tools, each run with `python -m llama_cu_awq_torch.tools.<name>`:
the offline AWQ tools convert_awq_to_bin (stage 1) and pack_weights
(stage 2); ppl_matrix (perplexity over the quantization levers);
make_test_model (a tiny random model.bin and tokenizer.bin); and
export_tokenizer (tokenizer.bin from a sentencepiece model)."""
