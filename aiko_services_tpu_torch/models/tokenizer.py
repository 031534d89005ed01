"""Tokenizers for the serving elements (counterpart of
``aiko_services_tpu/models/tokenizer.py``).

``ByteTokenizer`` is the dependency-free default (byte-level, 256 +
specials).  ``load_tokenizer`` loads a local HuggingFace tokenizer
directory or file through ``transformers.AutoTokenizer``.  One
deliberate difference: the JAX package's ``load_tokenizer`` returns a
``ByteTokenizer`` in silence when the path is missing or fails to load;
the port's raises, so a path given is loaded or the frame that asked
for it fails.
"""

from __future__ import annotations

import os

__all__ = ["ByteTokenizer", "load_tokenizer"]


class ByteTokenizer:
    """Byte-level: token = byte value; specials above 255."""

    PAD = 256
    BOS = 257
    EOS = 258

    vocab_size = 512       # leave headroom so tiny models align

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        tokens = list(text.encode("utf-8"))
        return ([self.BOS] + tokens) if add_bos else tokens

    def decode(self, tokens) -> str:
        data = bytes(t for t in tokens if 0 <= int(t) < 256)
        return data.decode("utf-8", errors="replace")

    @property
    def eos_tokens(self) -> tuple:
        return (self.EOS,)


class _HFTokenizer:
    def __init__(self, tokenizer):
        self._tok = tokenizer
        self.vocab_size = tokenizer.vocab_size

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, tokens) -> str:
        return self._tok.decode(list(map(int, tokens)),
                                skip_special_tokens=True)

    @property
    def eos_tokens(self) -> tuple:
        eos = self._tok.eos_token_id
        return (eos,) if eos is not None else ()


def load_tokenizer(path: str | None = None):
    """Local tokenizer directory/file -> HF tokenizer; no path -> bytes.
    A path that does not exist or does not load raises."""
    if not path:
        return ByteTokenizer()
    if not os.path.exists(path):
        raise FileNotFoundError(f"tokenizer {path!r} does not exist")
    from transformers import AutoTokenizer
    return _HFTokenizer(AutoTokenizer.from_pretrained(path))
