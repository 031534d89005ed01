"""The device loop's capture laid over several cards, on the CPU
(``models/loop_graph.py`` ``GraphCards`` and ``LoopRunner._capture``,
``parallel/mesh.py`` ``_streams``): which card captures, which cards
fork from it, which stream each mesh position launches on, and the
order of the warm-up, the pools, the fork, the capture and the join;
and how a replay launches (torch's first, then the exec with the GIL
held, after the prologue of a graph that draws).

No card is touched: the plans take ``torch.device("cuda", i)``
descriptors, and the capture's order is read from a recording stand-in
for the few ``torch.cuda`` calls it makes.  The JAX package has no
counterpart (its loop is one XLA program over every chip), so nothing
here runs JAX.  On the card the same capture runs in
``tests/test_torch_mesh_cuda.py``."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.models import llama, loop_graph
from aiko_services_tpu_torch.models.loop_graph import (GraphCards,
                                                       LoopRunner, _tensors)
from aiko_services_tpu_torch.models.paged import init_paged_cache
from aiko_services_tpu_torch.parallel import MeshPlan, make_mesh
from aiko_services_tpu_torch.parallel import mesh as mesh_module


def cuda(index: int) -> torch.device:
    return torch.device("cuda", index)


@pytest.mark.parametrize("name,axes,cards,forked", [
    ("one card twice", {"tp": 2}, [0, 0], []),
    ("tp2 on cards 0 and 1", {"tp": 2}, [0, 1], [1]),
    ("dp2 x tp2 on cards 0, 1, 0, 1", {"dp": 2, "tp": 2}, [0, 1, 0, 1], [1]),
    ("tp4 on four cards", {"tp": 4}, [0, 1, 2, 3], [1, 2, 3]),
])
def test_graph_cards_fork_every_other_card(name, axes, cards, forked):
    """The runner's device captures; each other card of the mesh forks
    once, however many positions it holds."""
    mesh = make_mesh(axes, [cuda(i) for i in cards])
    plan = GraphCards(cuda(0), mesh.devices.flat)
    assert plan.capture == cuda(0)
    assert plan.forked == tuple(cuda(i) for i in forked)
    assert plan.streams is None and plan.pools == {}


def test_graph_cards_on_the_cpu_capture_nothing():
    """A CPU mesh (and an unplaced CPU tree) has no capture card and no
    fork; an unplaced tree on a card captures alone."""
    mesh = make_mesh({"dp": 2, "tp": 2},
                     [torch.device("cpu", i) for i in range(4)])
    plan = GraphCards(torch.device("cpu"), mesh.devices.flat)
    assert plan.capture is None and plan.forked == ()
    assert GraphCards(torch.device("cpu")).capture is None
    alone = GraphCards(torch.device("cuda"))
    assert alone.capture == cuda(0) and alone.forked == ()


class FakeStream:
    def __init__(self, device, name, log):
        self.device, self.name, self._log = device, name, log

    def wait_stream(self, other):
        self._log.append(("wait", self.name, other.name))

    def __repr__(self):
        return self.name


class FakeCuda:
    """The ``torch.cuda`` calls of a capture, recorded: the current
    stream per card and the current device of the calling thread."""

    def __init__(self, cards):
        self.log = []
        self.defaults = {card: FakeStream(card, f"default{card.index}",
                                          self.log) for card in cards}
        self.current = dict(self.defaults)
        self.device = cards[0]
        self.made = 0
        self.pools = 0

    def Stream(self, card):
        self.made += 1
        return FakeStream(card, f"stream{card.index}", self.log)

    def current_stream(self, card):
        return self.current[card]

    def set_stream(self, stream):
        self.current[stream.device] = stream
        self.device = stream.device

    def set_device(self, card):
        self.device = card

    @contextlib.contextmanager
    def stream(self, stream):
        before, device = self.current[stream.device], self.device
        self.set_stream(stream)
        try:
            yield
        finally:
            self.current[stream.device] = before
            self.device = device

    def synchronize(self, card):
        self.log.append(("synchronize", card.index))

    def graph_pool_handle(self):
        self.pools += 1
        return (0, self.pools)

    def CUDAGraph(self):
        log = self.log

        class Graph:
            def register_generator_state(self, generator):
                log.append(("generator",))
        return Graph()

    @contextlib.contextmanager
    def graph(self, graph, stream, capture_error_mode):
        assert capture_error_mode == "thread_local"
        self.log.append(("capture", stream.name))
        with self.stream(stream):
            yield
            self.log.append(("end capture", self.device.index,
                             self.current[self.device].name))

    def install(self, monkeypatch):
        for name in ("Stream", "current_stream", "set_stream", "set_device",
                     "stream", "synchronize", "graph_pool_handle",
                     "CUDAGraph", "graph"):
            monkeypatch.setattr(torch.cuda, name, getattr(self, name))
        for name in ("begin", "end", "release"):
            monkeypatch.setattr(
                torch._C, {"begin": "_cuda_beginAllocateToPool",
                           "end": "_cuda_endAllocateToPool",
                           "release": "_cuda_releasePool"}[name],
                lambda card, pool, name=name: self.log.append(
                    (f"{name} pool", card, pool)), raising=False)


def test_positions_launch_on_the_callers_streams(monkeypatch):
    """``dp2 x tp2`` on cards 0, 1, 0, 1: each position is handed the
    caller's current stream on every card of the mesh, its own card's
    last -- so each card's two positions share one stream."""
    fake = FakeCuda([cuda(0), cuda(1)])
    fake.install(monkeypatch)
    fake.current[cuda(1)] = FakeStream(cuda(1), "forked1", fake.log)
    mesh = make_mesh({"dp": 2, "tp": 2}, [cuda(i) for i in (0, 1, 0, 1)])
    streams = mesh_module._streams(mesh)
    names = [[stream.name for stream in position] for position in streams]
    assert names == [["forked1", "default0"], ["default0", "forked1"],
                     ["forked1", "default0"], ["default0", "forked1"]]
    cpu = make_mesh({"tp": 2}, [torch.device("cpu", i) for i in range(2)])
    assert mesh_module._streams(cpu) == [(), ()]


def runner(devices, device=torch.device("cpu")) -> LoopRunner:
    """A runner whose cards are ``devices`` (its buffers on the CPU)."""
    config = llama.LlamaConfig.tiny(64, 64)
    made = LoopRunner({}, config, batch=2, ring=4, speculative="off",
                      spec_tokens=4, spec_window=8, draft=None, top_k=1,
                      generator=torch.Generator(), history_width=1,
                      device=device)
    made.cards = GraphCards(devices[0], devices)
    return made


def recording_loop(fake, fail_in_capture=False):
    def loop(cache, inputs, **overrides):
        capturing = any(entry[0] == "capture" for entry in fake.log)
        fake.log.append(("loop", "capture" if capturing else "warm-up",
                         fake.device.index,
                         tuple(sorted((card.index, stream.name) for card,
                                      stream in fake.current.items()))))
        if capturing and fail_in_capture:
            raise RuntimeError("capture failed")
        return {name: inputs[name] for name in
                ("tokens", "lengths", "active", "budget", "history")}
    return loop


def test_capture_forks_every_card_and_holds_its_pool(monkeypatch):
    """The capture over cards 0 and 1: the warm-up and the capture run
    with card 1's runner stream current (card 0 current as the device),
    every card synchronised before the capture, card 1's allocations in
    a pool of its own from before the capture to after it, the fork
    right after the capture begins and the join right before it ends;
    the caller's streams come back, and ``reset`` releases the pool."""
    fake = FakeCuda([cuda(0), cuda(1)])
    fake.install(monkeypatch)
    made = runner([cuda(0), cuda(1)])
    made._loop = recording_loop(fake)
    made._capture({"k": torch.zeros(1)})
    both = ((0, "stream0"), (1, "stream1"))
    assert fake.log == [
        ("wait", "stream0", "default0"), ("wait", "stream1", "default1"),
        ("wait", "stream1", "stream0"),                       # fork
        ("loop", "warm-up", 0, both),
        ("wait", "stream0", "stream1"),                       # join
        ("wait", "default0", "stream0"), ("wait", "default1", "stream1"),
        ("synchronize", 0), ("synchronize", 1),
        ("generator",),
        ("begin pool", 1, (0, 1)),
        ("wait", "stream0", "default0"), ("wait", "stream1", "default1"),
        ("capture", "stream0"),
        ("wait", "stream1", "stream0"),                       # fork
        ("loop", "capture", 0, both),
        ("wait", "stream0", "stream1"),                       # join
        ("end capture", 0, "stream0"),
        ("wait", "default0", "stream0"), ("wait", "default1", "stream1"),
        ("end pool", 1, (0, 1))]
    assert fake.current == fake.defaults and fake.device == cuda(0)
    assert fake.made == 2 and made.captures == 1
    assert made.cards.pools == {cuda(1): (0, 1)}
    fake.log.clear()
    made.reset()
    assert fake.log == [("release pool", 1, (0, 1))]
    assert made.cards.pools == {}
    made._capture({"k": torch.zeros(1)})          # streams made once
    assert fake.made == 2 and made.cards.pools == {cuda(1): (0, 2)}


def test_capture_on_one_card_forks_nothing(monkeypatch):
    """Card 0 listed twice: no forked stream, no pool; the capture runs
    on the runner's own capture stream."""
    fake = FakeCuda([cuda(0)])
    fake.install(monkeypatch)
    made = runner([cuda(0), cuda(0)])
    made._loop = recording_loop(fake)
    made._capture({"k": torch.zeros(1)})
    assert not [entry for entry in fake.log if "pool" in entry[0]]
    assert ("loop", "capture", 0, ((0, "stream0"),)) in fake.log
    assert fake.made == 1 and made.cards.pools == {}


def test_failed_capture_releases_its_pools_and_raises(monkeypatch):
    """A capture that fails raises (no eager block in its place), ends
    and releases the pools it began, and gives the caller back its
    streams."""
    fake = FakeCuda([cuda(0), cuda(1)])
    fake.install(monkeypatch)
    made = runner([cuda(0), cuda(1)])
    made._loop = recording_loop(fake, fail_in_capture=True)
    with pytest.raises(RuntimeError, match="capture failed"):
        made._capture({"k": torch.zeros(1)})
    pools = [entry for entry in fake.log if "pool" in entry[0]]
    assert pools == [("begin pool", 1, (0, 1)), ("end pool", 1, (0, 1)),
                     ("release pool", 1, (0, 1))]
    assert fake.current == fake.defaults and made._graph is None


def test_replay_is_ordered_with_every_card(monkeypatch):
    """A replay waits on each forked card's current stream, and each
    forked card's current stream waits on the replay's."""
    fake = FakeCuda([cuda(0), cuda(1), cuda(2)])
    fake.install(monkeypatch)
    cards = GraphCards(cuda(0), [cuda(0), cuda(1), cuda(2)])
    with cards.ordered():
        fake.log.append(("replay",))
    assert fake.log == [("wait", "default0", "default1"),
                        ("wait", "default0", "default2"), ("replay",),
                        ("wait", "default1", "default0"),
                        ("wait", "default2", "default0")]


def test_pointer_check_covers_every_page_table():
    """A paged cache placed over distinct devices holds a page table a
    device: the runner's pointer check walks each of them."""
    config = dataclasses.replace(llama.LlamaConfig.tiny(64, 64),
                                 dtype="float32")
    plan = MeshPlan(make_mesh({"tp": 2}, [torch.device("cpu", i)
                                          for i in range(2)]))
    cache = plan.put(init_paged_cache(config, 2, 64, 8, 17, device="cpu"),
                     llama.paged_cache_specs(config))
    tables = {id(shard["page_table"]) for shard in cache.shards}
    assert len(tables) == 2
    assert tables <= {id(tensor) for tensor in _tensors(cache)}
    assert len(LoopRunner._pointers(cache)) == len(list(_tensors(cache)))
    assert np.all(np.array(LoopRunner._pointers(cache)) > 0)


class FakeGenerator:
    def __init__(self, offset: int):
        self.offset = offset

    def get_offset(self) -> int:
        return self.offset

    def set_offset(self, offset: int) -> None:
        self.offset = offset


class FakeGraph:
    """A captured graph whose replay draws ``draws`` offsets from each
    generator it names."""

    def __init__(self, log, name, draws=()):
        self.log, self.name, self.draws = log, name, list(draws)

    def register_generator_state(self, generator):
        self.draws.append((generator, 4))       # the prologue's one draw

    def replay(self):
        self.log.append(("replay", self.name))
        for generator, count in self.draws:
            generator.offset += count

    def raw_cuda_graph_exec(self) -> int:
        return 0x5e


@pytest.mark.parametrize("case", ["direct", "default generator drawn",
                                  "no runtime", "draws nothing"])
def test_replay_launches_the_exec_holding_the_gil(monkeypatch, case):
    """The first replay after a capture is torch's, and tells how the
    later ones launch: the exec through the runtime's launch (which holds
    the GIL) on the capture card's current stream, after the prologue's
    replay where the graph draws from the runner's generator, whose
    offset then advances by what the first replay took; torch's replay
    each time where the runtime is no loaded library or the graph drew
    from the card's default generator.  ``reset`` decides anew."""
    fake = FakeCuda([cuda(0)])
    fake.install(monkeypatch)
    fake.current[cuda(0)].cuda_stream = 0x57
    default = FakeGenerator(0)
    monkeypatch.setattr(torch.cuda, "default_generators", (default,))
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda: FakeGraph(fake.log, "prologue"))
    monkeypatch.setattr(torch, "rand", lambda *shape, **_: None)
    launches = []
    monkeypatch.setattr(loop_graph, "runtime_launch", lambda: None
                        if case == "no runtime" else
                        lambda graph_exec, stream: launches.append(
                            (graph_exec, stream)))
    made = runner([cuda(0)])
    made.generator = FakeGenerator(8)
    draws = {"direct": [(made.generator, 12)],
             "default generator drawn": [(made.generator, 12), (default, 4)],
             "no runtime": [(made.generator, 12)],
             "draws nothing": []}[case]
    cache = {"k": torch.zeros(1)}
    for capture in range(2):
        made._graph = FakeGraph(fake.log, "loop", draws)
        made._bound = made._pointers(cache)
        fake.log.clear()
        launches.clear()
        start = made.generator.offset
        for _ in range(3):
            made._replay(cache)
        replays = [entry[1] for entry in fake.log if entry[0] == "replay"]
        if case in ("direct", "draws nothing"):
            assert made._direct is True and launches == [(0x5e, 0x57)] * 2
            if case == "direct":
                assert replays == ["loop", "prologue", "prologue"]
                assert made.generator.offset == start + 3 * 12
            else:
                assert replays == ["loop"] and made._prologue is None
                assert made.generator.offset == start
        else:
            assert made._direct is False and launches == []
            assert replays == ["loop"] * 3
        made.reset()
        assert made._direct is None and made._prologue is None
    assert made.replays == 6


def test_no_runtime_launch_without_a_cuda_runtime():
    """A build without CUDA has no runtime to launch through: the
    runners replay through torch."""
    if torch.version.cuda is not None:
        pytest.skip("this build has a CUDA runtime")
    assert loop_graph.runtime_launch() is None
