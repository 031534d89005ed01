"""The one generator of the benchmark's traffic, driven by a mix file.

Every seed gets the same set of sizes in another order.  The pool of
requests is a run of blocks of ``block`` requests; each block holds
the prompt and answer lengths at ``block`` evenly spaced quantiles of
the mix's distributions and the same share of greedy requests, and the
seed shuffles each of the three within the block (so any stretch of
whole blocks carries the same work, whatever the seed).  The seed also
draws the token ids and the frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass
class Ask:
    index: int
    prompt: list
    new_tokens: int
    temperature: float


def _quantiles(count: int) -> np.ndarray:
    return (np.arange(count) + 0.5) / count


def prompt_lengths(spec: dict, count: int) -> np.ndarray:
    """``lognormal_median`` / ``sigma`` clipped to [min, max]."""
    normal = NormalDist()
    z = np.array([normal.inv_cdf(q) for q in _quantiles(count)])
    lengths = np.exp(np.log(spec["lognormal_median"]) + spec["sigma"] * z)
    return np.clip(np.rint(lengths), spec["min"], spec["max"]).astype(int)


def output_lengths(spec: dict, count: int) -> np.ndarray:
    """Uniform over [uniform_min, uniform_max]."""
    low, high = spec["uniform_min"], spec["uniform_max"]
    return np.rint(low + (high - low) * _quantiles(count)).astype(int)


def _blocks(values: np.ndarray, blocks: int, rng) -> np.ndarray:
    return np.concatenate([rng.permutation(values) for _ in range(blocks)])


def requests(mix: dict, vocab: int, seed: int) -> list:
    """The mix's pool of requests for ``seed``, in sending order."""
    rng = np.random.default_rng(seed)
    block, count = mix["block"], mix["pool"]
    blocks = -(-count // block)
    prompts = _blocks(prompt_lengths(mix["prompt_tokens"], block), blocks,
                      rng)
    outputs = _blocks(output_lengths(mix["output_tokens"], block), blocks,
                      rng)
    greedy = _blocks(np.arange(block) < round(mix["greedy_share"] * block),
                     blocks, rng)
    ids = rng.integers(0, vocab, int(prompts[:count].sum()))
    pool, at = [], 0
    for index in range(count):
        n = int(prompts[index])
        pool.append(Ask(index, ids[at:at + n].tolist(), int(outputs[index]),
                        0.0 if greedy[index] else float(mix["temperature"])))
        at += n
    return pool


def frames(mix: dict, seed: int) -> list:
    """The mix's pool of camera frames for ``seed`` (uint8 HWC)."""
    rng = np.random.default_rng(seed)
    spec = mix["frame"]
    shape = (spec["height"], spec["width"], spec["channels"])
    return [rng.integers(0, 256, shape, dtype=np.uint8)
            for _ in range(mix["pool"])]
