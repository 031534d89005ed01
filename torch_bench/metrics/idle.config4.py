"""The traced slice's share with no device operation
(``readers.idle``)."""

from torch_bench import readers

read = readers.idle
