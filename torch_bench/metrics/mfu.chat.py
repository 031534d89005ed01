"""The model's share of the card's bf16 peak (``readers.mfu``)."""

from torch_bench import readers

read = readers.mfu
