"""Checkpoint / resume for the port's model-hosting elements.

Counterpart of ``aiko_services_tpu/models/checkpoint.py`` with the same
API (``Checkpointer``, ``save_pytree``, ``restore_pytree``,
``maybe_restore``).  The JAX package wraps orbax; the port writes the
safetensors format itself (``models/_safetensors.py``):

- a step is ``<directory>/<step>/state.safetensors`` plus
  ``metadata.json``; a tensor's name is its pytree path joined with
  ``.``, dict keys and list indices alike (``params.layers.wq``,
  ``params.heads.0.w``), and the file's ``__metadata__`` keeps the
  tree's skeleton, so a restore without a template rebuilds lists as
  lists;
- ``save`` copies every leaf to the host before it returns, then a
  background thread writes the step (into ``<step>.partial``, renamed
  when complete) and drops the oldest steps beyond ``keep``; the caller
  may change its tensors at once.  ``save(..., wait=True)`` writes in
  the caller's thread without the copy;
- ``restore`` streams each leaf from the mapped file through a pinned
  host buffer onto its device, one leaf at a time, so a restore never
  holds two trees: a ``template`` of meta tensors (shapes and dtypes,
  no storage) is enough.  Every leaf's shape and dtype must match the
  template's, and the template's memory format is kept
  (``channels_last`` detector kernels);
- a ``plan`` (``parallel.MeshPlan``) restores onto its device; with
  ``specs`` (a tree of ``P`` matching the template's, None where a
  subtree stays whole) each placed subtree comes back a
  ``parallel.Placed`` tree, every position reading its own slice of
  each leaf from the mapped file (``plan.put`` of the saved tree);
- ``save`` of a tree holding placed subtrees writes their gathered
  leaves.

The port cannot read the orbax checkpoints the JAX package writes
(orbax needs jax).  The way across is conversion from the HF source
(``models/convert.py``) or the numpy bridge (``models/bridge.py``).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..device import resolve_device, sync_allowed
from ..parallel.mesh import MeshPlan, P, Placed, _placed
from ._safetensors import SafetensorsFile, write_file

__all__ = ["Checkpointer", "save_pytree", "restore_pytree",
           "maybe_restore", "restore_or_init", "flatten", "unflatten"]

STATE_FILE = "state.safetensors"
METADATA_FILE = "metadata.json"
_SKELETON_KEY = "aiko_pytree"
#: the pinned staging buffers a restore copies through (two, so one
#: fills while the other's copy to the card runs).
STAGING_BYTES = 64 * 2 ** 20


def flatten(tree, prefix: str = "") -> dict:
    """{"a.b.0.c": leaf} in the tree's order, dict keys and list indices
    joined with '.'."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(flatten(value, f"{prefix}.{key}" if prefix else str(key)))
    return out


def _skeleton(tree):
    if isinstance(tree, dict):
        return {str(key): _skeleton(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_skeleton(value) for value in tree]
    return None


def unflatten(skeleton, leaves: dict, prefix: str = ""):
    """The inverse of :func:`flatten` over a skeleton (dicts, lists and
    ``None`` leaves)."""
    def name(key):
        return f"{prefix}.{key}" if prefix else str(key)
    if isinstance(skeleton, dict):
        return {key: unflatten(value, leaves, name(key))
                for key, value in skeleton.items()}
    if isinstance(skeleton, list):
        return [unflatten(value, leaves, name(index))
                for index, value in enumerate(skeleton)]
    return leaves[prefix]


def _host_tensor(leaf, name: str) -> torch.Tensor:
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    raise TypeError(f"checkpoint leaf {name!r} is a {type(leaf).__name__}, "
                    f"not a tensor")


def _write_step(directory: pathlib.Path, step: int, leaves: dict,
                skeleton, meta: dict, keep: int) -> None:
    final = directory / str(step)
    partial = directory / f"{step}.partial"
    shutil.rmtree(partial, ignore_errors=True)
    partial.mkdir(parents=True)
    write_file(partial / STATE_FILE, leaves,
               metadata={_SKELETON_KEY: json.dumps(skeleton)})
    (partial / METADATA_FILE).write_text(json.dumps(meta))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(partial, final)
    for old in _steps(directory)[:-keep] if keep else []:
        shutil.rmtree(directory / str(old), ignore_errors=True)


def _steps(directory: pathlib.Path) -> list[int]:
    if not directory.is_dir():
        return []
    return sorted(int(entry.name) for entry in directory.iterdir()
                  if entry.name.isdigit()
                  and (entry / STATE_FILE).is_file())


class _Stager:
    """Host -> device copies through two pinned buffers: chunk i fills
    one buffer while chunk i-1's copy to the card runs from the other."""

    def __init__(self):
        self.buffers = [torch.empty(STAGING_BYTES, dtype=torch.uint8,
                                    pin_memory=True) for _ in range(2)]
        self.events = [None, None]
        self.turn = 0

    def copy(self, source: torch.Tensor, target: torch.Tensor) -> None:
        """``target`` (contiguous, on the card) <- ``source`` (host),
        byte for byte."""
        src = _byte_view(source)
        dst = _byte_view(target)
        for begin in range(0, src.numel(), STAGING_BYTES):
            end = min(begin + STAGING_BYTES, src.numel())
            slot = self.turn
            self.turn ^= 1
            if self.events[slot] is not None:
                self.events[slot].synchronize()
            staged = self.buffers[slot][:end - begin]
            staged.copy_(src[begin:end])
            dst[begin:end].copy_(staged, non_blocking=True)
            self.events[slot] = torch.cuda.Event()
            self.events[slot].record()

    def finish(self) -> None:
        for event in self.events:
            if event is not None:
                event.synchronize()


def _byte_view(tensor: torch.Tensor) -> torch.Tensor:
    return tensor.reshape(-1).view(torch.uint8)


class Checkpointer:
    """Step-numbered checkpoints under a root directory.

    >>> ckpt = Checkpointer(path, keep=3)
    >>> ckpt.save(step, {"params": params}, metadata={"config": ...})
    >>> state = ckpt.restore(template={"params": template}, plan=plan)
    """

    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = int(keep)
        self._writer: threading.Thread | None = None
        self._error: Exception | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: dict, metadata: dict | None = None,
             wait: bool = False) -> None:
        """Save ``state`` (a tree of tensors on any device) as ``step``.
        Every leaf is on the host when this returns; the file is written
        by a background thread unless ``wait``."""
        self.wait()
        meta = dict(metadata or {})
        meta.setdefault("step", step)
        meta.setdefault("saved_unix_time", time.time())
        meta = json.loads(json.dumps(meta, default=str))
        state = _gathered(state)
        leaves = {name: _host_tensor(leaf, name)
                  for name, leaf in flatten(state).items()}
        args = (self.directory, int(step), leaves, _skeleton(state), meta,
                self.keep)
        with sync_allowed():            # a planned copy to the host
            leaves.update({name: tensor.to("cpu", copy=not wait)
                           for name, tensor in leaves.items()})
        if wait:
            _write_step(*args)
            return

        def write():
            try:
                _write_step(*args)
            except Exception as error:          # surfaced by wait()
                self._error = error
        self._writer = threading.Thread(target=write, daemon=True,
                                        name=f"checkpoint-{step}")
        self._writer.start()

    def wait(self) -> None:
        """Block until the pending save is written; re-raise its error."""
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.join()
        error, self._error = self._error, None
        if error is not None:
            raise error

    # -- restore ------------------------------------------------------------

    @property
    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return _steps(self.directory)

    def _step_directory(self, step: int | None) -> pathlib.Path:
        self.wait()
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self.directory / str(step)
        if not (path / STATE_FILE).is_file():
            raise FileNotFoundError(f"no checkpoint step {step} in "
                                    f"{self.directory}")
        return path

    def restore(self, step: int | None = None, template: Any = None,
                plan: MeshPlan | None = None, specs: Any = None,
                device: str | torch.device | None = None) -> dict:
        """Restore a checkpoint (the latest step unless ``step``).

        ``template``: a tree of tensors (meta tensors suffice) giving the
        structure, shapes and dtypes; a difference raises and names the
        leaf.  The device is the ``plan``'s, else ``device``, else a
        template leaf's own device when it has storage, else the card.
        With ``plan`` and ``specs`` (a tree of ``P`` matching the
        template's, None where a subtree stays whole on ``plan.device``;
        a single ``P`` broadcasts) each placed subtree comes back placed
        (``plan.put``), each position reading its own slice of every
        leaf from the mapped file.  Without a template the saved tree
        comes back as saved."""
        path = self._step_directory(step)
        source = SafetensorsFile(path / STATE_FILE)
        if plan is not None:
            target = _placed(plan.device)
        elif device is not None:
            target = resolve_device(device)
        else:
            target = None
        if template is None:
            skeleton = json.loads(source.metadata()[_SKELETON_KEY])
            wanted = {name: None for name in source.keys()}
        else:
            skeleton = _skeleton(template)
            wanted = flatten(template)
            extra = sorted(set(source.keys()) - set(wanted))
            missing = sorted(set(wanted) - set(source.keys()))
            if missing or extra:
                raise ValueError(
                    f"checkpoint {path}: the template's leaves differ from "
                    f"the saved ones (missing {missing[:5]}, not in the "
                    f"template {extra[:5]})")
        if plan is not None and specs is not None:
            return _restore_placed(source, skeleton, wanted, plan, specs,
                                   target)
        restored = _load_leaves(source, wanted, target)
        return unflatten(skeleton, restored)

    def metadata(self, step: int | None = None) -> dict:
        try:
            path = self._step_directory(step)
            return json.loads((path / METADATA_FILE).read_text())
        except (FileNotFoundError, ValueError):
            return {}

    def close(self):
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _gathered(tree):
    """``tree`` with every placed subtree gathered whole."""
    if isinstance(tree, Placed):
        return tree.gather(MeshPlan(tree.mesh).device)
    if isinstance(tree, dict):
        return {key: _gathered(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gathered(value) for value in tree)
    return tree


def _spec_tree(specs) -> bool:
    """Whether ``specs`` is a ``P`` or a tree of nothing but ``P``."""
    if isinstance(specs, P):
        return True
    if isinstance(specs, dict):
        return all(map(_spec_tree, specs.values()))
    if isinstance(specs, (list, tuple)):
        return all(map(_spec_tree, specs))
    return False


def _restore_placed(source, skeleton, wanted: dict, plan: MeshPlan, specs,
                    target):
    """The saved tree (a dict: a checkpoint's state) with each subtree
    below its root that ``specs`` lays out (a tree of ``P`` alone)
    placed by it as one placed tree: ``plan.put`` of the mapped leaves
    (each position copies its own slice); the subtrees under None loaded
    whole onto ``target``."""
    def within(prefix):
        return {key: like for key, like in wanted.items()
                if not prefix or key == prefix
                or key.startswith(prefix + ".")}

    def walk(skeleton, specs, prefix):
        if specs is None:
            return unflatten(skeleton, _load_leaves(
                source, within(prefix), target), prefix)
        if _spec_tree(specs) and prefix:
            host = {}
            for key, like in within(prefix).items():
                host[key] = source.get_tensor(key)
                if like is not None and (
                        tuple(like.shape) != tuple(host[key].shape)
                        or like.dtype != host[key].dtype):
                    raise ValueError(
                        f"checkpoint leaf {key!r}: saved {host[key].dtype} "
                        f"{list(host[key].shape)}, the template holds "
                        f"{like.dtype} {list(like.shape)}")
            with sync_allowed():
                return plan.put(unflatten(skeleton, host, prefix), specs)
        keys = skeleton if isinstance(skeleton, dict) \
            else range(len(skeleton))
        parts = {key: walk(skeleton[key], specs if isinstance(specs, P)
                           else specs[key] if isinstance(specs, (list, tuple))
                           else specs.get(key),
                           f"{prefix}.{key}" if prefix else str(key))
                 for key in keys}
        return parts if isinstance(skeleton, dict) else list(parts.values())
    return walk(skeleton, specs, "")


def _load_leaves(source: SafetensorsFile, wanted: dict, target) -> dict:
    """Each leaf of ``wanted`` (name -> template leaf or None) from the
    file onto its device, one leaf at a time."""
    stagers: dict = {}
    out = {}
    with sync_allowed():        # the staging buffers' planned waits
        for name, like in wanted.items():
            shape, dtype = source.shape(name), source.dtype(name)
            if like is not None and (tuple(like.shape) != shape
                                     or like.dtype != dtype):
                raise ValueError(
                    f"checkpoint leaf {name!r}: saved {dtype} "
                    f"{list(shape)}, the template holds {like.dtype} "
                    f"{list(like.shape)}")
            device = target
            if device is None:
                device = like.device if like is not None \
                    and like.device.type != "meta" else resolve_device(None)
            host = source.get_tensor(name)
            dense = torch.empty(shape, dtype=dtype, device=device)
            if device.type == "cuda":
                stager = stagers.get(device)
                if stager is None:
                    stager = stagers[device] = _Stager()
                with torch.cuda.device(device):
                    stager.copy(host, dense)
            else:
                dense.copy_(host)
            if like is not None and not like.is_contiguous() \
                    and like.is_contiguous(
                        memory_format=torch.channels_last):
                dense = dense.contiguous(memory_format=torch.channels_last)
            out[name] = dense
        for stager in stagers.values():
            stager.finish()
    return out


def save_pytree(directory, state: dict, metadata: dict | None = None):
    """One-shot synchronous save (step 0)."""
    with Checkpointer(directory, keep=1) as ckpt:
        ckpt.save(0, state, metadata=metadata, wait=True)


def restore_pytree(directory, template=None, plan=None, specs=None,
                   device=None) -> dict:
    directory = pathlib.Path(directory)
    if not directory.is_dir():
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    with Checkpointer(directory) as ckpt:
        return ckpt.restore(template=template, plan=plan, specs=specs,
                            device=device)


def maybe_restore(params, checkpoint: str | None, device=None):
    """The model-hosting elements' checkpoint contract: ``params`` is
    the restore template (a fresh tree, or meta tensors); if
    ``checkpoint`` names a checkpoint directory, its ``params`` replace
    it, on ``device`` or the template leaves' own."""
    if checkpoint:
        params = restore_pytree(checkpoint, template={"params": params},
                                device=device)["params"]
    return params


def restore_or_init(model, config, seed: int, checkpoint: str | None,
                    device):
    """A model's weights on ``device``: restored from ``checkpoint``
    against ``model.abstract_params(config)`` (shapes only, nothing
    drawn), else ``model.init_params(seed, config, device)``.  ``model``
    is one of the port's model modules."""
    device = resolve_device(device)
    if checkpoint:
        return maybe_restore(model.abstract_params(config), checkpoint,
                             device=device)
    return model.init_params(int(seed), config, device)
