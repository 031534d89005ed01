"""Byte-level tokenizer for the serving path (counterpart of
``ByteTokenizer`` in ``aiko_services_tpu/models/tokenizer.py``; the
HuggingFace loader waits for real checkpoints in the repository)."""

from __future__ import annotations

__all__ = ["ByteTokenizer"]


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
