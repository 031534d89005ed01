"""Repeatability of the mixture-of-experts training step on the card.

    python3 aiko_services_tpu_torch/moe_repeat.py [--root DIR]
        [--mesh one|ep2tp2-card|ep2tp2-cards] [--runs N] [--deterministic]

Runs ``chip_smoke.py`` phase 11c's MoE training step (4 experts at
Llama-3.2-1B widths, top-2, capacity factor 2.0, ``max_seq`` 512,
remat, bf16, seed 0; one batch of 2 x 512 tokens from numpy seed 0)
from scratch ``--runs`` times in this process over a mesh: ``one`` a
single position on card 0, ``ep2tp2-card`` ``{"ep": 2, "tp": 2}`` over
card 0 listed four times, ``ep2tp2-cards`` the same over cards 0-3.
Each run prints one ``moe-repeat`` JSON line: the gradients' equality
to the first run's (bit for bit, each leaf, at the initial weights),
three AdamW steps' losses and CUDA-event ms, the SHA-256 of the updated
tree, and the card with its power limit.  ``--deterministic`` runs
under ``torch.use_deterministic_algorithms(True, warn_only=True)``
with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and prints the operations
PyTorch flags.  ``--root DIR`` imports the package from another
checkout (a parent unpacked by ``git archive``), so two commits compare
on the same cards in one call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

MESHES = {"one": ({"dp": 1}, [0]), "ep2tp2-card": ({"ep": 2, "tp": 2},
                                                    [0] * 4),
          "ep2tp2-cards": ({"ep": 2, "tp": 2}, [0, 1, 2, 3])}
STEPS = 3
BATCH = (2, 512)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def moe_config():
    from aiko_services_tpu_torch.models import llama
    return dataclasses.replace(llama.LlamaConfig.llama3_1b(), n_experts=4,
                               max_seq=512, remat=True)


def one_run(config, axes: dict, devices: list, first: list | None) -> dict:
    """Gradients at the initial weights (compared with ``first``'s, or
    kept as the first), then STEPS AdamW steps; returns the run's
    record and its gradients on the host."""
    import numpy as np
    import torch
    from aiko_services_tpu_torch.models import train
    from aiko_services_tpu_torch.models.checkpoint import flatten
    from aiko_services_tpu_torch.parallel import MeshPlan, Placed, make_mesh
    plan = MeshPlan(make_mesh(axes, devices))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, config.vocab_size, BATCH)).to(plan.device)
    params, state, _ = train.init_train_state(0, config, plan)
    _, grads = train.value_and_grad(params, config, tokens)
    if isinstance(grads, Placed):
        grads = plan.gather(grads)
    grads = [leaf.detach().cpu() for _, leaf in sorted(
        flatten(grads).items())]
    step = train.make_train_step(config, plan)
    losses, times = [], []
    for _ in range(STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, loss = step(params, state, tokens)
        end.record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        times.append(start.elapsed_time(end))
    whole = plan.gather(params) if isinstance(params, Placed) else params
    digest = hashlib.sha256()
    for name, leaf in sorted(flatten(whole).items()):
        digest.update(name.encode())
        digest.update(leaf.detach().contiguous().view(torch.uint8).cpu()
                      .numpy().tobytes())
    same = None if first is None else len(first) == len(grads) and all(
        torch.equal(a, b) for a, b in zip(first, grads))
    return {"grads_equal_first": same, "losses": losses, "step_ms": times,
            "checksum": digest.hexdigest()}, grads


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=None)
    parser.add_argument("--mesh", choices=sorted(MESHES),
                        default="ep2tp2-cards")
    parser.add_argument("--runs", type=int, default=2)
    parser.add_argument("--deterministic", action="store_true")
    args = parser.parse_args()
    if args.deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    root = Path(args.root or Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("moe_repeat: needs a CUDA card", file=sys.stderr)
        return 1
    axes, indices = MESHES[args.mesh]
    devices = [torch.device("cuda", index) for index in indices]
    flagged: set = set()
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        warnings.showwarning = \
            lambda message, *rest, **kw: flagged.add(str(message)[:300])
    card, config, first = card_line(), moe_config(), None
    for index in range(args.runs):
        record, grads = one_run(config, axes, devices, first)
        first = first if first is not None else grads
        print("moe-repeat " + json.dumps({
            "root": str(args.root or "."), "mesh": args.mesh,
            "deterministic": args.deterministic, "run": index, **record,
            "card": card}), flush=True)
        torch.cuda.empty_cache()
    if args.deterministic:
        print("moe-repeat flagged " + json.dumps(sorted(flagged)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
