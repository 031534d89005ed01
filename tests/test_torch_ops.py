"""Port parity: ``aiko_services_tpu_torch.ops`` against the JAX package's
``ops`` on the same seeded numpy inputs, at float32 (atol = rtol = 1e-4;
the two differ only in summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu import ops as jops
from aiko_services_tpu.ops import layers as jl
from aiko_services_tpu.ops import tiles as jtiles
from aiko_services_tpu.models.tokenizer import ByteTokenizer as JaxBytes
from aiko_services_tpu.utils.misc import next_power_of_two as jax_npot
from aiko_services_tpu_torch import ops as tops
from aiko_services_tpu_torch.ops import layers as tl
from aiko_services_tpu_torch.ops import tiles as ttiles
from aiko_services_tpu_torch.models.tokenizer import ByteTokenizer
from aiko_services_tpu_torch.utils.misc import next_power_of_two

TOL = dict(atol=1e-4, rtol=1e-4)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _both(array):
    array = np.asarray(array)
    return jnp.asarray(array), torch.from_numpy(array.copy())


def _close(jax_out, torch_out, **tol):
    np.testing.assert_allclose(np.asarray(torch_out, dtype=np.float64),
                               np.asarray(jax_out, dtype=np.float64),
                               **(tol or TOL))


def test_rms_norm():
    rng = _rng(1)
    xj, xt = _both(rng.normal(size=(2, 5, 16)).astype(np.float32))
    wj, wt = _both(rng.normal(size=(16,)).astype(np.float32))
    _close(jl.rms_norm(xj, wj, 1e-5), tl.rms_norm(xt, wt, 1e-5))


def test_rope_frequencies():
    _close(jl.rope_frequencies(16, 40, 10_000.0),
           tl.rope_frequencies(16, 40, 10_000.0, device="cpu"),
           atol=0, rtol=0)


def test_apply_rope():
    rng = _rng(2)
    xj, xt = _both(rng.normal(size=(2, 6, 4, 16)).astype(np.float32))
    pj, pt = _both(rng.integers(0, 40, (2, 6)).astype(np.int32))
    table = tl.rope_frequencies(16, 40, 500_000.0, device="cpu")
    _close(jl.apply_rope(xj, jl.rope_frequencies(16, 40, 500_000.0), pj),
           tl.apply_rope(xt, table, pt))


def test_swiglu():
    rng = _rng(3)
    arrays = [rng.normal(size=shape).astype(np.float32) * 0.3
              for shape in ((3, 8), (8, 12), (8, 12), (12, 8))]
    pairs = [_both(a) for a in arrays]
    _close(jl.swiglu(*[p[0] for p in pairs]),
           tl.swiglu(*[p[1] for p in pairs]))


@pytest.mark.parametrize("repeats", [1, 3])
def test_repeat_kv(repeats):
    xj, xt = _both(_rng(4).normal(size=(2, 5, 2, 4)).astype(np.float32))
    _close(jl.repeat_kv(xj, repeats), tl.repeat_kv(xt, repeats),
           atol=0, rtol=0)


@pytest.mark.parametrize("variant", ["plain", "length_mask", "kv_positions"])
def test_attention_prefill(variant):
    rng = _rng(5)
    b, s, h, kv, t, d = 2, 5, 4, 2, 12, 8
    qj, qt = _both(rng.normal(size=(b, s, h, d)).astype(np.float32))
    kj, kt = _both(rng.normal(size=(b, t, kv, d)).astype(np.float32))
    vj, vt = _both(rng.normal(size=(b, t, kv, d)).astype(np.float32))
    pj, pt = _both(np.array([[3, 4, 5, 6, 7], [7, 8, 9, 10, 11]],
                            dtype=np.int32))
    kwargs_j, kwargs_t = {}, {}
    if variant == "length_mask":
        mask = np.arange(t)[None, :] < np.array([[9], [12]])
        kwargs_j["kv_length_mask"], kwargs_t["kv_length_mask"] = _both(mask)
    if variant == "kv_positions":
        positions = rng.permutation(t)[None, :].repeat(b, 0)
        kwargs_j["kv_positions"], kwargs_t["kv_positions"] = _both(
            positions.astype(np.int32))
    _close(jl.attention_prefill(qj, kj, vj, pj, **kwargs_j),
           tl.attention_prefill(qt, kt, vt, pt, **kwargs_t))


def test_attention_decode():
    rng = _rng(6)
    b, h, kv, t, d = 3, 4, 2, 10, 8
    qj, qt = _both(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    kj, kt = _both(rng.normal(size=(b, t, kv, d)).astype(np.float32))
    vj, vt = _both(rng.normal(size=(b, t, kv, d)).astype(np.float32))
    lj, lt = _both(np.array([1, 10, 4], dtype=np.int32))
    _close(jl.attention_decode(qj, kj, vj, lj),
           tl.attention_decode(qt, kt, vt, lt))


@pytest.mark.parametrize("lengths", [[0, 1, 9], [5, 5, 5]])
def test_attention_decode_append(lengths):
    rng = _rng(7)
    b, h, kv, t, d = 3, 4, 2, 10, 8
    qj, qt = _both(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    kj, kt = _both(rng.normal(size=(b, t, kv, d)).astype(np.float32))
    vj, vt = _both(rng.normal(size=(b, t, kv, d)).astype(np.float32))
    knj, knt = _both(rng.normal(size=(b, 1, kv, d)).astype(np.float32))
    vnj, vnt = _both(rng.normal(size=(b, 1, kv, d)).astype(np.float32))
    lj, lt = _both(np.array(lengths, dtype=np.int32))
    _close(jl.attention_decode_append(qj, kj, vj, knj, vnj, lj),
           tl.attention_decode_append(qt, kt, vt, knt, vnt, lt))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 1000])
def test_tiles_and_power_of_two(n):
    assert ttiles.round_up(n, 8) == jtiles.round_up(n, 8)
    assert next_power_of_two(n) == jax_npot(n)
    x = _rng(8).normal(size=(3, n)).astype(np.float32)
    _close(jtiles.pad_to(jnp.asarray(x), 1, 8),
           ttiles.pad_to(torch.from_numpy(x), 1, 8), atol=0, rtol=0)


@pytest.mark.parametrize("requested", ["dense", "flash", "auto",
                                       "reference"])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("extent", [None, 256, 1024, 1100, 2048])
@pytest.mark.parametrize("page_tokens", [None, 8, 12])
def test_decode_backend_matches(requested, paged, extent, page_tokens):
    kwargs = dict(paged=paged, extent=extent, threshold=1024,
                  page_tokens=page_tokens)
    assert tops.decode_backend(requested, **kwargs) \
        == jops.decode_backend(requested, **kwargs)
    assert tops.decode_backend(requested, distributed=True, **kwargs) \
        == "reference"


def test_matmul_backend_probe():
    """The JAX probe's counterpart: ``pallas`` forces the kernel's route
    (here the CUDA kernel, whose wrapper runs its plain version on a CPU
    tensor), ``auto`` takes it on a CUDA device only, ``off`` never."""
    assert tops.matmul_backend("pallas", "cpu") == "cuda-int8"
    assert tops.matmul_backend("auto", "cpu") == "reference"
    assert tops.matmul_backend("off", "cpu") == "reference"
    assert jops.matmul_backend("off") == "reference"
    if torch.cuda.is_available():
        assert tops.matmul_backend("auto", "cuda") == "cuda-int8"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tops.matmul_backend("auto", "cuda")


@pytest.mark.parametrize("text", ["", "hello", "naïve ✓"])
def test_byte_tokenizer_matches(text):
    ours, theirs = ByteTokenizer(), JaxBytes()
    assert ours.encode(text) == theirs.encode(text)
    assert ours.decode(ours.encode(text)) == theirs.decode(
        theirs.encode(text))
    assert ours.eos_tokens == theirs.eos_tokens
