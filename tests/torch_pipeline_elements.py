"""Test PipelineElements of the PyTorch port's engine, loaded by module
path: twins of ``tests/pipeline_elements.py``.  Imports only the port.

Also the tests' device pool: :func:`cpu_pool` patches
``device.local_devices`` (the port's ``jax.devices()``) to eight CPU
descriptors, the counterpart of ``tests/conftest.py``'s eight virtual
JAX devices; a test module imports the fixture by name.  The media
collectors at the end are the twins of ``tests/tests_media_helpers.py``
(a test swaps ``SINK``)."""

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch import device as device_rule
from aiko_services_tpu_torch.pipeline import (PipelineElement, StreamEvent,
                                              TPUElement)

CPU_POOL = tuple(torch.device("cpu", index) for index in range(8))


@pytest.fixture
def cpu_pool(monkeypatch):
    """Eight CPU descriptors as the process's device pool."""
    monkeypatch.setattr(device_rule, "local_devices",
                        lambda: list(CPU_POOL))
    return list(CPU_POOL)


class ElementA(PipelineElement):
    """outputs a -> (a)"""

    def process_frame(self, stream, a):
        return StreamEvent.OKAY, {"a": int(a)}


class ElementB(PipelineElement):
    """input a (or mapped), output b = a + 1"""

    def process_frame(self, stream, a):
        return StreamEvent.OKAY, {"b": int(a) + 1}


class ElementC(PipelineElement):
    """input b (or mapped), output c = b * 2"""

    def process_frame(self, stream, b):
        return StreamEvent.OKAY, {"c": int(b) * 2}


class Doubler(PipelineElement):
    def process_frame(self, stream, x):
        return StreamEvent.OKAY, {"x": int(x) * 2}


class AddOne(PipelineElement):
    def process_frame(self, stream, x):
        return StreamEvent.OKAY, {"x": int(x) + 1}


class Failer(PipelineElement):
    def process_frame(self, stream, **inputs):
        return StreamEvent.ERROR, {"diagnostic": "deliberate failure"}


class Raiser(PipelineElement):
    def process_frame(self, stream, **inputs):
        raise RuntimeError("exploded")


class Counter(PipelineElement):
    """Increments n each visit -- loop body element."""

    def process_frame(self, stream, n=0):
        return StreamEvent.OKAY, {"n": int(n) + 1}


class Stopper(PipelineElement):
    def process_frame(self, stream, **inputs):
        return StreamEvent.STOP, {}


class TensorScale(TPUElement):
    """Placed element: x -> x * factor on the element's device,
    jit-cached."""

    def __init__(self, context):
        super().__init__(context)
        self._scale = self.jit(lambda x, f: x * f)

    def process_frame(self, stream, x):
        factor, _ = self.get_parameter("factor", 2.0)
        return StreamEvent.OKAY, {"x": self._scale(x, float(factor))}


class TensorSum(TPUElement):
    """Reduce x to a scalar tensor."""

    def __init__(self, context):
        super().__init__(context)
        self._sum = self.jit(lambda x: x.sum())

    def process_frame(self, stream, x):
        return StreamEvent.OKAY, {"total": self._sum(x)}


# -- media collectors (twins of tests/tests_media_helpers.py); SINK is
# swapped per test.

SINK: list = []


class Collect(PipelineElement):
    def process_frame(self, stream, image=None, **inputs):
        SINK.append(np.asarray(image))
        return StreamEvent.OKAY, {}


class CollectSpectrum(PipelineElement):
    def process_frame(self, stream, spectrum=None, **inputs):
        SINK.append(np.asarray(spectrum))
        return StreamEvent.OKAY, {}


class CollectText(PipelineElement):
    def process_frame(self, stream, text=None, **inputs):
        SINK.append(text)
        return StreamEvent.OKAY, {}
