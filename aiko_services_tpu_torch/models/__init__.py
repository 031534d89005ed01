"""Models of the PyTorch port: Llama-3 serving (dense and paged KV), its
int8 quantization, the numpy parameter bridge and the byte tokenizer."""
