"""Host-side utilities of the PyTorch port."""

from .misc import next_power_of_two, not_ported

__all__ = ["next_power_of_two", "not_ported"]
