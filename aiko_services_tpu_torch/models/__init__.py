"""Models of the PyTorch port: Llama-3 serving (dense and paged KV,
dense or mixture-of-experts FFN), its int8 quantization, the training
step (``train``), the context-parallel forward and loss
(``long_context``), the detector and speech models, checkpoints and HF
weight conversion, the numpy parameter bridge and the tokenizers."""
from . import convert
from . import detector
from . import llama
from . import long_context
from . import train
from .batching import ContinuousBatcher, Request
from .checkpoint import (Checkpointer, save_pytree, restore_pytree,
                         maybe_restore)
from .tokenizer import ByteTokenizer, load_tokenizer
