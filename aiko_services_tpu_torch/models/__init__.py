"""Models of the PyTorch port: Llama-3 serving (dense and paged KV), its
int8 quantization, the detector and speech models, checkpoints and HF
weight conversion, the numpy parameter bridge and the tokenizers.  (The
JAX package's ``long_context`` waits for multi-card meshes, ROADMAP
Queue 1 item 7.)"""
from . import convert
from . import detector
from . import llama
from .batching import ContinuousBatcher, Request
from .checkpoint import (Checkpointer, save_pytree, restore_pytree,
                         maybe_restore)
from .tokenizer import ByteTokenizer, load_tokenizer
