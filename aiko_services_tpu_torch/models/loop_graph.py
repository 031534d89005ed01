"""Device-loop blocks, run eagerly on the CPU and through one captured
CUDA graph on the card.

The JAX package jits its device-resident loop (``_decode_loop_jit``, a
``lax.while_loop``) and dispatches one compiled program per block.  The
port's ``llama.decode_loop`` is the same block as a fixed number of
masked iterations with no host synchronisation -- a few thousand kernel
launches at llama3-8b widths, which eager PyTorch would enqueue one by
one from the host for every block.  :class:`LoopRunner` captures that
launch sequence once as a ``torch.cuda.CUDAGraph`` and replays it:

- one runner per batcher, which fixes the speculative mode, the cache
  layout and payload, the ring and top-k: it captures once, and again
  only after :meth:`LoopRunner.reset` (``recover()`` rebuilds the cache)
  or when the stop-token table grows wider;
- the graph reads STATIC input buffers that the runner owns
  (``inputs``: tokens, lengths, active, budget, temperatures, eos rows
  and history).  The caller edits them in place between blocks (a
  joining request's first token and budget, a finished row's active
  flag) and uploads host mirrors through pinned memory (:meth:`upload`);
- the cache and the page table keep their storage: the runner records
  their addresses at capture and raises if a replay finds one moved
  (the batcher's page-table sync copies into the table in place);
- right after each replay the carries are copied into the inputs on
  the device, so the next block chains off this one with no host round
  trip; the outputs stay valid until the next replay, so a caller that
  needs them later enqueues their copy first (the batcher's
  ``_HostCopy``);
- the batcher's generator is registered with the graph, so every replay
  draws fresh numbers (a captured generator state replayed as it is
  would repeat the same draws every block);
- the kernel wrappers count launches as Python runs them, which during
  a capture reaches no card: the runner takes the capture's counts back
  and adds them again at every replay, so the counters count launches
  that ran.

On the CPU the same ``decode_loop`` runs eagerly on the same buffers.
On the card a capture that fails raises: there is no eager fallback.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import llama
from ..ops import launch_counters

__all__ = ["LoopRunner"]

#: decode_loop's return tuple, by name (None: the generator).
OUTPUTS = ("emitted", "counts", "tokens", "lengths", "active", "budget",
           "history", None, "accepted", "drafted", "steps")
#: the outputs that chain into the next block's inputs.
CARRIES = ("tokens", "lengths", "active", "budget", "history")


def _tensors(tree):
    """Every tensor of a cache dict, int8 leaves included."""
    for value in tree.values():
        if isinstance(value, dict):
            yield from _tensors(value)
        else:
            yield value


class LoopRunner:
    """``decode_loop`` blocks for one batch of ``batch`` rows: see the
    module docstring.  ``history_width`` is the ngram window (1 for the
    other modes); ``generator`` draws every sample."""

    def __init__(self, params: dict, config: llama.LlamaConfig, *,
                 batch: int, ring: int, speculative: str, spec_tokens: int,
                 spec_window: int, draft: dict | None, top_k: int,
                 generator: torch.Generator, history_width: int,
                 device: torch.device):
        self.params, self.config, self.draft = params, config, draft
        self.options = dict(ring=int(ring), speculative=speculative,
                            spec_tokens=int(spec_tokens),
                            spec_window=int(spec_window), top_k=int(top_k))
        self.generator = generator
        self.device = device

        def zeros(dtype, *shape):
            return torch.zeros((batch, *shape), dtype=dtype, device=device)
        self.inputs = {
            "tokens": zeros(torch.int32), "lengths": zeros(torch.int32),
            "active": zeros(torch.bool), "budget": zeros(torch.int32),
            "temperatures": zeros(torch.float32),
            "eos": zeros(torch.int32, 1) - 1,
            "history": zeros(torch.int32, history_width) - 1}
        self._graph = None
        self._outputs: dict | None = None
        self._bound: tuple = ()
        self._launch_delta: dict = {}
        # what the serving run reports: captures, replays, capture time
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def upload(self, name: str, array: np.ndarray) -> None:
        """A host mirror into input ``name``, in place (pinned and
        asynchronous on the card).  A new shape (a wider eos table)
        reallocates the buffer and drops the captured graph."""
        source = torch.from_numpy(np.ascontiguousarray(array))
        target = self.inputs[name]
        if tuple(source.shape) != tuple(target.shape):
            self.inputs[name] = target = torch.empty(
                source.shape, dtype=target.dtype, device=self.device)
            self.reset()
        if self.device.type == "cuda":
            source = source.pin_memory()
        target.copy_(source, non_blocking=self.device.type == "cuda")

    def reset(self) -> None:
        """Drop the captured graph (the cache was rebuilt, or an input
        buffer reallocated); the next :meth:`run` captures anew."""
        self._graph = None
        self._outputs = None
        self._bound = ()
        self._launch_delta = {}

    def _loop(self, cache: dict, inputs: dict, **overrides) -> dict:
        out = llama.decode_loop(
            self.params, self.config, inputs["tokens"], cache,
            inputs["lengths"], inputs["active"], inputs["budget"],
            inputs["temperatures"], inputs["eos"], inputs["history"],
            self.generator, draft=self.draft,
            **{**self.options, **overrides})
        return {name: value for name, value in zip(OUTPUTS, out) if name}

    def run(self, cache: dict) -> dict:
        """One block from the current inputs: the outputs by name
        (``emitted``, ``counts``, the carries, ``accepted``, ``drafted``,
        ``steps``), the carries already copied into the inputs.  On the
        card the outputs are the graph's buffers, valid until the next
        run."""
        if self.device.type != "cuda":
            outputs = self._loop(cache, self.inputs)
        else:
            if self._graph is None:
                self._capture(cache)
            if self._pointers(cache) != self._bound:
                raise RuntimeError(
                    "LoopRunner: the cache or page table moved since the "
                    "graph was captured; reset() the runner after "
                    "rebuilding the cache")
            self._graph.replay()
            for (wrapper, attr), count in self._launch_delta.items():
                setattr(wrapper, attr, getattr(wrapper, attr) + count)
            self.replays += 1
            outputs = self._outputs
        for name in CARRIES:
            if outputs[name] is not self.inputs[name]:
                self.inputs[name].copy_(outputs[name])
        return outputs

    @staticmethod
    def _pointers(cache: dict) -> tuple:
        return tuple(tensor.data_ptr() for tensor in _tensors(cache))

    def _capture(self, cache: dict) -> None:
        """Warm up, then capture one block on the current inputs."""
        begin = time.perf_counter()
        stream = torch.cuda.current_stream(self.device)
        # Warm-up outside the capture: one iteration with every row
        # inactive (writes only the trash position) loads the kernel
        # library, sets the kernels' shared-memory limits and
        # initialises cuBLAS before the capture records anything.
        warm = {name: tensor.clone() for name, tensor in self.inputs.items()}
        warm["active"].zero_()
        spec = self.options["speculative"] != "off"
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._loop(cache, warm,
                       ring=self.options["spec_tokens"] + 1 if spec else 1)
        stream.wait_stream(side)
        counters = list(launch_counters().values())
        before = [getattr(wrapper, attr) for wrapper, attr in counters]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph):
            outputs = self._loop(cache, self.inputs)
        self._launch_delta = {}
        for (wrapper, attr), start in zip(counters, before):
            captured = getattr(wrapper, attr) - start
            setattr(wrapper, attr, start)
            if captured:
                self._launch_delta[wrapper, attr] = captured
        self._graph, self._outputs = graph, outputs
        self._bound = self._pointers(cache)
        self.captures += 1
        self.capture_s += time.perf_counter() - begin
