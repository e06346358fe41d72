"""The port's tools, each run with `python -m llama_cu_awq_torch.tools.<name>`:
the offline AWQ tools convert_awq_to_bin (stage 1) and pack_weights
(stage 2); ppl_matrix (perplexity over the quantization levers);
make_test_model (a tiny random model.bin and tokenizer.bin);
export_tokenizer (tokenizer.bin from a sentencepiece model); build_corpus
(real text from installed packages' documentation) and train_tiny (a
small float Llama trained on it, exported as an AWQ dump). The shell
script real_model_e2e.sh chains them: corpus, training, packing, then
generate, speculative decoding, perplexity and the ppl matrix."""
