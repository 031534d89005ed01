"""Models of the PyTorch port: Llama-3 serving, its cache predicates,
the numpy parameter bridge and the byte tokenizer."""
