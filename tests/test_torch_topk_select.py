"""Top-k (#6) by threshold select, on the plain version of the kernel's
own algorithm (``topk_threshold_reference``: order-preserving keys,
radix histograms of 12, 10 and 10 bits, the tie rule, chunks and their
merge), held against ``lax.top_k`` and the JAX package's Pallas top-k in
interpret mode: values and indices exact, ties to the lowest index, no
duplicate index.  -0 and +0 are equal values, tied by index, as in the
Pallas kernel and the stable sort; ``lax.top_k`` alone orders -0 below
+0, so the row that holds both is left out of its comparison.  The CUDA
kernel is held to the same rows on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.ops import pallas_topk as jtopk
from aiko_services_tpu_torch.ops.topk import (
    order_keys, radix_threshold, topk_plan, topk_reference,
    topk_threshold_reference)


SIGNED_ZEROS = 5       # the row of _rows that holds -0 beside +0


def _rows(v, seed=0):
    """Rows with ties at the threshold, everything tied, mostly -inf, all
    -inf, -0 beside +0, and plain random values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(7, v)).astype(np.float32)
    x[0, [3, 11, v // 2, v - 1]] = 7.0            # tied maxima
    x[0, 100:260] = 2.5                           # a 160-way tie below them
    x[1, :] = 0.5                                 # everything tied
    x[2, :] = -np.inf                             # mostly -inf
    x[2, [4, v - 2]] = 1.0
    x[3, :] = -np.inf                             # all -inf
    x[4, ::3] = x[4, 0]                           # ties at a random value
    x[5, :] = 0.0                                 # -0 beside +0
    x[5, 1::2] = -0.0
    x[5, [9, 700]] = 3.0
    return x


def _equal_to_lax(values, indices, lax_values, lax_indices):
    """Equal to lax.top_k's values everywhere and its indices on every row
    but the signed-zeros one."""
    np.testing.assert_array_equal(values.numpy(), np.asarray(lax_values))
    rows = [r for r in range(values.shape[0]) if r != SIGNED_ZEROS]
    np.testing.assert_array_equal(indices.numpy()[rows],
                                  np.asarray(lax_indices)[rows])


@pytest.mark.parametrize("k", [1, 50, 128])
def test_threshold_select_matches_lax_and_pallas(k):
    """V = 1000, not a multiple of the 256-element chunk: the last chunk
    is short and pads with absent slots."""
    x = _rows(1000)
    values, indices = topk_threshold_reference(torch.from_numpy(x), k)
    pv, pi = jtopk.topk(jnp.asarray(x), k, block_v=512, interpret=True)
    lv, li = jax.lax.top_k(jnp.asarray(x), k)
    assert indices.dtype == torch.int32
    np.testing.assert_array_equal(values.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(indices.numpy(), np.asarray(pi))
    _equal_to_lax(values, indices, lv, li)
    for row in indices.numpy():
        assert len(set(row.tolist())) == k


@pytest.mark.parametrize("v,k", [(40_000, 1), (40_000, 50), (40_000, 128),
                                 (128_256, 50), (5_001, 128)])
def test_threshold_select_matches_lax_at_every_chunk_size(v, k):
    """Wider rows take other chunk sizes (topk_plan): still lax.top_k's
    values and indices exactly, and the stable sort's."""
    x = _rows(v, seed=v + k)[:6]
    values, indices = topk_threshold_reference(torch.from_numpy(x), k)
    _equal_to_lax(values, indices, *jax.lax.top_k(jnp.asarray(x), k))
    ref_v, ref_i = topk_reference(torch.from_numpy(x), k)
    assert torch.equal(indices, ref_i) and torch.equal(values, ref_v)


@pytest.mark.parametrize("k", [1, 50, 128])
def test_radix_threshold_is_the_kth_key_and_its_tie_count(k):
    """The radix rounds find the k-th largest key of each row -- or stop
    at its prefix once the whole chosen bin is needed -- and how many
    keys equal to it the top k take (k minus those above)."""
    x = torch.from_numpy(_rows(3000, seed=k))
    keys = order_keys(x)
    tau, mask, need = radix_threshold(keys, k)
    kth = torch.sort(keys, dim=1, descending=True).values[:, k - 1]
    masked = keys & mask[:, None]
    assert torch.equal(tau, kth & mask)
    assert torch.equal(need, k - (masked > tau[:, None]).sum(1))
    equal = (masked == tau[:, None]).sum(1)
    full = mask == 0xFFFFFFFF
    assert bool((need >= 1).all()) and bool((need <= equal).all())
    assert bool((need[~full] == equal[~full]).all())
    assert bool(full.any()) and bool((~full).any())


def test_order_keys_preserve_float_order():
    """Keys are monotone in the value, -0 and +0 share one key, a NaN sorts
    above +inf (the stable sort's order), every key above the absent
    slot's 0."""
    values = torch.tensor([-np.inf, -3e38, -1.0, -1e-45, -0.0, 0.0, 1e-45,
                           1.0, 3e38, np.inf, np.nan], dtype=torch.float32)
    keys = order_keys(values)
    assert bool((keys[1:-1] >= keys[:-2]).all())
    assert keys[4] == keys[5]
    assert bool((keys[:4] < keys[4]).all() and (keys[6:] > keys[5]).all())
    assert keys[-1] == 0xFFFFFFFF and bool((keys > 0).all())


def test_plan_fills_the_card_within_the_merge():
    """The chunk plan depends on (B, V, k) only: the largest chunk that
    gives 2 x 132 blocks or more where the merge holds the candidates (8
    rows of Llama-3's vocabulary: 63 chunks of 2,048 at every k), the
    smallest the merge holds otherwise (one 40,000-wide row at k 128:
    40 of 1,024), and a V too wide for the merge raises."""
    assert topk_plan(8, 128_256, 50) == (8, 63)
    assert topk_plan(8, 128_256, 1) == (8, 63)
    assert topk_plan(8, 128_256, 128) == (8, 63)
    assert topk_plan(4, 128_256, 50) == (4, 126)
    assert topk_plan(1, 40_000, 128) == (4, 40)
    with pytest.raises(ValueError, match="merge capacity"):
        topk_plan(8, 1_000_000, 128)
