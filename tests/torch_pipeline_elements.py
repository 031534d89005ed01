"""Test PipelineElements of the PyTorch port's engine, loaded by module
path: twins of ``tests/pipeline_elements.py`` (the tensor elements wait
for the port's placed element base).  Imports only the port."""

from aiko_services_tpu_torch.pipeline import PipelineElement, StreamEvent


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
