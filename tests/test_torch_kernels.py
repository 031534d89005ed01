"""Port parity for the kernels of the serving path: each plain PyTorch
version (what the wrapper runs on a CPU tensor) against the JAX Pallas
kernel in interpret mode on the same seeded inputs, the decode kernels
over bf16/f32 caches and over int8 caches.  Tolerances: float32 1e-4
(summation order), bf16 2e-2 (bf16 rounding of softmax weights), top-k
exact.  (The int8 matmul, kernel #5, is in test_torch_quant.py.)  The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``, which skips without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.ops import pallas_attention as jatt
from aiko_services_tpu.ops import pallas_decode as jdec
from aiko_services_tpu.ops import pallas_topk as jtopk
from aiko_services_tpu.models import quant as jq
from aiko_services_tpu_torch.models import quant as tq
from aiko_services_tpu_torch.ops import flash_attention as tatt
from aiko_services_tpu_torch.ops import flash_decode as tdec
from aiko_services_tpu_torch.ops.topk import topk

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _close(actual, expected, tol):
    np.testing.assert_allclose(np.asarray(actual, dtype=np.float64),
                               np.asarray(expected, dtype=np.float64),
                               **tol)


def _decode_inputs(seed, d, dtype):
    """[L=2, B=3, T=64, K=2 * d] cache, 4 query heads on 2 kv heads
    (GQA 4:2), lengths {0, 1, T-1}."""
    rng = np.random.default_rng(seed)
    n_layers, b, t, kv, h = 2, 3, 64, 2, 4
    k = rng.normal(size=(n_layers, b, t, kv * d)).astype(np.float32)
    v = rng.normal(size=(n_layers, b, t, kv * d)).astype(np.float32)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k_new = rng.normal(size=(b, 1, kv, d)).astype(np.float32)
    v_new = rng.normal(size=(b, 1, kv, d)).astype(np.float32)
    lengths = np.array([0, 1, t - 1], dtype=np.int32)
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jx = [jnp.asarray(a, jdtype) for a in (k, v, q, k_new, v_new)]
    tx = [_t(a).to(tdtype) for a in (k, v, q, k_new, v_new)]
    return jx, tx, lengths, h, kv


# d = 32: scale 2^-2.5 is no power of two -> f32 queries (the llama3-8b
# branch); d = 16: scale 1/4 folds into bf16 queries (the bf16 branch).
DECODE_CASES = [(32, "float32", F32), (32, "bfloat16", F32),
                (16, "bfloat16", BF16), (16, "float32", F32)]


@pytest.mark.parametrize("d,dtype,tol", DECODE_CASES)
def test_decode_kernel_plain_matches_pallas(d, dtype, tol):
    jx, tx, lengths, h, kv = _decode_inputs(1, d, dtype)
    (kj, vj, qj, _, _), (kt, vt, qt, _, _) = jx, tx
    q_pad_j, _, _, _ = jdec._prep_query(qj[:, 0], h, kv, d)
    q_t, _ = tdec._prep_query(qt[:, 0], d)
    # The port's queries and accumulator are compact: each head's own kv
    # block of the TPU kernel's block-diagonal [B, H, K*hd] layout.
    blocks = np.arange(h) // (h // kv)

    def own(x):
        return _np(x).reshape(3, h, kv, d)[:, np.arange(h), blocks]
    assert str(q_t.dtype) == f"torch.{q_pad_j.dtype}"
    _close(q_t.float(), own(q_pad_j), F32)
    layer = 1
    acc_j, m_j, l_j = jdec.flash_decode_attention_stacked(
        q_pad_j, kj, vj, None, None, layer, jnp.asarray(lengths))
    acc_t, m_t, l_t = tdec.flash_decode_attention_stacked(
        q_t, kt, vt, layer, _t(lengths))
    _close(acc_t, own(acc_j), tol)
    _close(m_t, _np(m_j), tol)
    _close(l_t, _np(l_j), tol)
    assert bool((m_t[0] == -1e30).all()) and float(l_t[0].abs().max()) == 0
    assert float(acc_t[0].abs().max()) == 0


@pytest.mark.parametrize("d,dtype,tol", DECODE_CASES)
def test_decode_append_matches_pallas(d, dtype, tol):
    jx, tx, lengths, h, kv = _decode_inputs(2, d, dtype)
    kj, vj, qj, knj, vnj = jx
    kt, vt, qt, knt, vnt = tx
    out_j = jdec.flash_decode_append_stacked(
        qj, jdec._split_stacked(kj), jdec._split_stacked(vj), 1, knj, vnj,
        jnp.asarray(lengths))
    out_t = tdec.flash_decode_append_stacked(
        qt, tdec._split_stacked(kt), tdec._split_stacked(vt), 1, knt, vnt,
        _t(lengths))
    assert out_t.dtype == tx[2].dtype
    assert torch.isfinite(out_t.float()).all()
    _close(out_t.float(), _np(out_j), tol)


ATTENTION_CASES = [(32, "float32", 0, 20, F32), (32, "float32", 9, 20, F32),
                   (16, "bfloat16", 9, 20, BF16),
                   (16, "float32", 30, 13, F32)]


@pytest.mark.parametrize("d,dtype,offset,s,tol", ATTENTION_CASES)
def test_attention_plain_matches_pallas(d, dtype, offset, s, tol):
    """q_offset > 0 and S not a multiple of the block; k/v span the
    whole slot row (T = 48), the tail hidden by causality."""
    rng = np.random.default_rng(3)
    b, h, kv, t = 2, 4, 2, 48
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    out_j = jatt.flash_attention(*(jnp.asarray(a, jdtype) for a in (q, k, v)),
                                 q_offset=offset, block_q=8, block_k=16)
    out_t = tatt.flash_attention(*(_t(a).to(tdtype) for a in (q, k, v)),
                                 q_offset=offset)
    assert out_t.dtype == tdtype
    _close(out_t.float(), _np(out_j), tol)


def _topk_rows(v):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, v)).astype(np.float32)
    x[0, [3, 11, v - 1]] = 7.0                     # tied maxima
    x[1, :] = 0.5                                  # everything tied
    x[2, :] = -np.inf                              # mostly -inf
    x[2, [4, v - 2]] = 1.0
    x[3, :] = -np.inf                              # all -inf
    x[4, ::3] = x[4, 0]                            # ties at a random value
    return x


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("v", [300, 128])
def test_topk_plain_matches_pallas_and_lax(k, v):
    x = _topk_rows(v)
    values, indices = topk(_t(x), k)
    pv, pi = jtopk.topk(jnp.asarray(x), k, block_v=128)
    lv, li = jax.lax.top_k(jnp.asarray(x), k)
    assert indices.dtype == torch.int32
    np.testing.assert_array_equal(values.numpy(), np.asarray(lv))
    np.testing.assert_array_equal(indices.numpy(), np.asarray(li))
    np.testing.assert_array_equal(values.numpy(), np.asarray(pv))
    np.testing.assert_array_equal(indices.numpy(), np.asarray(pi))
    for row in indices.numpy():
        assert len(set(row.tolist())) == k


@pytest.mark.parametrize("k", [0, 129, 301])
def test_topk_rejects_k_out_of_range(k):
    with pytest.raises(ValueError, match="must be in"):
        topk(torch.zeros(2, 300), k)


# -- kernels #3 (paged) and #1 (flat) ---------------------------------------

def _paged_inputs(seed, d, dtype, page_tokens=32):
    """The layout of the JAX package's ``_paged_case``
    (test_kernel_plane.py): L=2 layers, 3 slots x 4 logical pages, 2 kv
    heads x 2 query groups, pages scattered through a 13-page pool (page
    0 is trash), lengths {70, 128, 33} at pt=32."""
    rng = np.random.default_rng(seed)
    n_layers, pages, b, kv, h = 2, 13, 3, 2, 4
    pool_k = rng.normal(size=(n_layers, pages, page_tokens, kv * d))
    pool_v = rng.normal(size=(n_layers, pages, page_tokens, kv * d))
    q = rng.normal(size=(b, 1, h, d))
    k_new = rng.normal(size=(b, 1, kv, d))
    v_new = rng.normal(size=(b, 1, kv, d))
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 7], [8, 9, 0, 0]],
                     dtype=np.int32)
    lengths = np.array([70, 128, 33], dtype=np.int32) * page_tokens // 32
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    arrays = [a.astype(np.float32) for a in (pool_k, pool_v, q, k_new, v_new)]
    jx = [jnp.asarray(a, jdtype) for a in arrays]
    tx = [_t(a).to(tdtype) for a in arrays]
    return jx, tx, table, lengths, h, kv


def _own(x, h, kv, d):
    """The port's compact [B, H, hd] blocks of a block-diagonal
    [B, H, K*hd] TPU accumulator."""
    blocks = np.arange(h) // (h // kv)
    x = _np(x)
    return x.reshape(x.shape[0], h, kv, d)[:, np.arange(h), blocks]


@pytest.mark.parametrize("d,dtype,tol", DECODE_CASES)
def test_paged_kernel_plain_matches_pallas(d, dtype, tol):
    """The plain #3 (what the wrapper runs on a CPU tensor) against the
    Pallas paged kernel in interpret mode, on every layer."""
    jx, tx, table, lengths, h, kv = _paged_inputs(5, d, dtype)
    (kj, vj, qj, _, _), (kt, vt, qt, _, _) = jx, tx
    q_pad_j, _, _, _ = jdec._prep_query(qj[:, 0], h, kv, d)
    q_t, _ = tdec._prep_query(qt[:, 0], d)
    for layer in range(2):
        acc_j, m_j, l_j = jdec.flash_decode_attention_paged(
            q_pad_j, kj, vj, None, None, jnp.int32(layer),
            jnp.asarray(table), jnp.asarray(lengths), interpret=True)
        acc_t, m_t, l_t = tdec.flash_decode_attention_paged(
            q_t, kt, vt, layer, _t(table), _t(lengths))
        _close(acc_t, _own(acc_j, h, kv, d), tol)
        _close(m_t, _np(m_j), tol)
        _close(l_t, _np(l_j), tol)


@pytest.mark.parametrize("d,dtype,tol", DECODE_CASES)
def test_flat_kernel_plain_matches_pallas(d, dtype, tol):
    """The plain #1 against the Pallas flat kernel on the gathered view
    of the paged case, lengths 0 and T included."""
    jx, tx, table, lengths, h, kv = _paged_inputs(6, d, dtype)
    (kj, vj, qj, _, _), (kt, vt, qt, _, _) = jx, tx
    lengths = np.array([0, 128, 33], dtype=np.int32)
    q_pad_j, _, _, _ = jdec._prep_query(qj[:, 0], h, kv, d)
    q_t, _ = tdec._prep_query(qt[:, 0], d)
    kg = kt[1][_t(table).long()].reshape(3, 128, kv * d)
    vg = vt[1][_t(table).long()].reshape(3, 128, kv * d)
    acc_j, m_j, l_j = jdec.flash_decode_attention(
        q_pad_j, kj[1][jnp.asarray(table)].reshape(3, 128, kv * d),
        vj[1][jnp.asarray(table)].reshape(3, 128, kv * d), None, None,
        jnp.asarray(lengths), block_t=32, interpret=True)
    acc_t, m_t, l_t = tdec.flash_decode_attention(q_t, kg, vg, _t(lengths))
    _close(acc_t, _own(acc_j, h, kv, d), tol)
    _close(m_t, _np(m_j), tol)
    _close(l_t, _np(l_j), tol)
    assert bool((m_t[0] == -1e30).all()) and float(l_t[0].abs().max()) == 0


@pytest.mark.parametrize("page_tokens", [32, 16, 8])
def test_paged_plain_equals_flat_plain_on_gathered_view(page_tokens):
    """The port's twin of test_paged_kernel_bitwise_matches_dense_kernel
    for the plain versions: paged == flat on the gathered contiguous
    view, bit for bit, at page sizes at and below the kernel's 64-row
    tile (the CUDA kernels are held to the same in test_torch_cuda.py and
    chip_smoke.py)."""
    _, tx, table, lengths, h, kv = _paged_inputs(7, 32, "float32",
                                                 page_tokens)
    kt, vt, qt, _, _ = tx
    q_t, _ = tdec._prep_query(qt[:, 0], 32)
    for layer in range(2):
        paged = tdec.flash_decode_attention_paged(
            q_t, kt, vt, layer, _t(table), _t(lengths))
        flat = tdec.flash_decode_attention(
            q_t, kt[layer][_t(table).long()].reshape(3, -1, kv * 32),
            vt[layer][_t(table).long()].reshape(3, -1, kv * 32),
            _t(lengths))
        for a, b in zip(paged, flat):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [("float32", dict(atol=1e-5,
                                                         rtol=1e-5)),
                                       ("bfloat16", BF16)])
def test_paged_append_matches_pallas(dtype, tol):
    """flash_decode_append_paged (the JAX signature) against the JAX
    package's, f32 at the 1e-5 of test_kernel_plane.py's paged append
    test."""
    jx, tx, table, lengths, h, kv = _paged_inputs(8, 16, dtype)
    kj, vj, qj, knj, vnj = jx
    kt, vt, qt, knt, vnt = tx
    out_j = jdec.flash_decode_append_paged(
        qj, jdec._split_paged(kj), jdec._split_paged(vj), jnp.int32(1),
        knj, vnj, jnp.asarray(table), jnp.asarray(lengths), interpret=True)
    out_t = tdec.flash_decode_append_paged(
        qt, tdec._split_paged(kt), tdec._split_paged(vt), 1, knt, vnt,
        _t(table), _t(lengths))
    assert out_t.dtype == tx[2].dtype and out_t.shape == qt.shape
    _close(out_t.float(), _np(out_j), tol)


@pytest.mark.parametrize("d,dtype,tol", DECODE_CASES)
def test_flat_append_matches_pallas(d, dtype, tol):
    """flash_decode_append (grouped [B, T, K, hd] caches, the JAX
    signature) against the JAX package's."""
    jx, tx, lengths, h, kv = _decode_inputs(9, d, dtype)
    kj, vj, qj, knj, vnj = jx
    kt, vt, qt, knt, vnt = tx
    out_j = jdec.flash_decode_append(
        qj, kj[0].reshape(3, 64, kv, d), vj[0].reshape(3, 64, kv, d), knj,
        vnj, jnp.asarray(lengths), block_t=32, interpret=True)
    out_t = tdec.flash_decode_append(
        qt, kt[0].reshape(3, 64, kv, d), vt[0].reshape(3, 64, kv, d), knt,
        vnt, _t(lengths))
    assert out_t.dtype == tx[2].dtype
    _close(out_t.float(), _np(out_j), tol)


def test_paged_kernel_rejects_unaligned_pages():
    """Pages must be a multiple of 8 tokens, on every device (the JAX
    kernel refuses the same by name)."""
    _, tx, table, lengths, _, _ = _paged_inputs(10, 16, "float32", 12)
    kt, vt, qt, _, _ = tx
    with pytest.raises(ValueError, match="multiple of 8"):
        tdec.flash_decode_attention_paged(tdec._prep_query(qt[:, 0], 16)[0],
                                          kt, vt, 0, _t(table), _t(lengths))


# -- the int8 branches of #1, #2 and #3 --------------------------------------

def _int8_side(x, kv, d):
    """A [.., T, K*d] f32 cache side -> the JAX and the port int8 leaves
    ({"int8": [.., T, K*d], "scale": [.., T, K, 1]}, bit-equal)."""
    grouped = np.asarray(x, np.float32).reshape(*x.shape[:-1], kv, d)
    theirs = jq.quantize_kv(jnp.asarray(grouped))
    ours = tq.quantize_kv(_t(grouped))
    flat = x.shape
    return ({"int8": theirs["int8"].reshape(flat), "scale": theirs["scale"]},
            {"int8": ours["int8"].reshape(flat), "scale": ours["scale"]})


def _int8_case(seed, d, qdtype, page_tokens=32):
    """The paged case's pools quantized, its queries in ``qdtype``."""
    jx, _, table, lengths, h, kv = _paged_inputs(seed, d, "float32",
                                                 page_tokens)
    pools = [_int8_side(np.asarray(a), kv, d) for a in jx[:2]]
    rng = np.random.default_rng(seed + 100)
    q = rng.normal(size=(3, 1, h, d)).astype(np.float32)
    new = [rng.normal(size=(3, 1, kv, d)).astype(np.float32)
           for _ in range(2)]
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[qdtype]
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[qdtype]
    return (pools, (jnp.asarray(q, jdtype), _t(q).to(tdtype)),
            [(jnp.asarray(a, jdtype), _t(a).to(tdtype)) for a in new],
            table, lengths, h, kv)


def _scales_t(leaf):
    """The TPU kernels' [.., K, T] scales from a stored [.., T, K, 1]."""
    return jnp.swapaxes(leaf["scale"][..., 0], -1, -2)


@pytest.mark.parametrize("d,dtype,tol", DECODE_CASES)
def test_int8_paged_kernel_plain_matches_pallas(d, dtype, tol):
    """Plain #3 over int8 pools (scale pools riding their pages) against
    the Pallas paged kernel in interpret mode, on every layer: exact
    in-kernel dequantization on both sides."""
    (kp, vp), (qj, qt), _, table, lengths, h, kv = _int8_case(11, d, dtype)
    q_pad_j, _, _, _ = jdec._prep_query(qj[:, 0], h, kv, d)
    q_t, _ = tdec._prep_query(qt[:, 0], d)
    (k_j, ks_j), (v_j, vs_j) = jdec._split_paged(kp[0]), \
        jdec._split_paged(vp[0])
    (k_t, ks_t), (v_t, vs_t) = tdec._split_paged(kp[1]), \
        tdec._split_paged(vp[1])
    for layer in range(2):
        acc_j, m_j, l_j = jdec.flash_decode_attention_paged(
            q_pad_j, k_j, v_j, ks_j, vs_j, jnp.int32(layer),
            jnp.asarray(table), jnp.asarray(lengths), interpret=True)
        acc_t, m_t, l_t = tdec.flash_decode_attention_paged(
            q_t, k_t, v_t, layer, _t(table), _t(lengths), ks_t, vs_t)
        _close(acc_t, _own(acc_j, h, kv, d), tol)
        _close(m_t, _np(m_j), tol)
        _close(l_t, _np(l_j), tol)


@pytest.mark.parametrize("d,dtype,tol", DECODE_CASES)
def test_int8_stacked_and_flat_kernels_plain_match_pallas(d, dtype, tol):
    """Plain #2 on the stacked int8 cache (the gathered pools seen as
    [L, B, T, C]) and plain #1 on one layer of it, against the Pallas
    stacked and flat kernels, lengths 0 and T included."""
    (kp, vp), (qj, qt), _, table, _, h, kv = _int8_case(12, d, dtype)
    lengths = np.array([0, 128, 33], dtype=np.int32)

    def stacked(leaf, gather):
        return {name: gather(arr) for name, arr in leaf.items()}

    def jgather(arr):
        return arr[:, jnp.asarray(table)].reshape(2, 3, 128, *arr.shape[3:])

    def tgather(arr):
        return arr[:, _t(table).long()].reshape(2, 3, 128, *arr.shape[3:])
    kj, vj = stacked(kp[0], jgather), stacked(vp[0], jgather)
    kt, vt = stacked(kp[1], tgather), stacked(vp[1], tgather)
    q_pad_j, _, _, _ = jdec._prep_query(qj[:, 0], h, kv, d)
    q_t, _ = tdec._prep_query(qt[:, 0], d)
    acc_j, m_j, l_j = jdec.flash_decode_attention_stacked(
        q_pad_j, kj["int8"], vj["int8"], _scales_t(kj), _scales_t(vj), 1,
        jnp.asarray(lengths), block_t=128, interpret=True)
    (k_t, ks_t), (v_t, vs_t) = tdec._split_stacked(kt), \
        tdec._split_stacked(vt)
    got = tdec.flash_decode_attention_stacked(q_t, k_t, v_t, 1,
                                              _t(lengths), ks_t, vs_t)
    for ours, theirs in zip(got, (_own(acc_j, h, kv, d), _np(m_j),
                                  _np(l_j))):
        _close(ours, theirs, tol)
    layer_j = {name: arr[1] for name, arr in kj.items()}
    layer_vj = {name: arr[1] for name, arr in vj.items()}
    acc_j, m_j, l_j = jdec.flash_decode_attention(
        q_pad_j, layer_j["int8"], layer_vj["int8"], _scales_t(layer_j),
        _scales_t(layer_vj), jnp.asarray(lengths), block_t=32,
        interpret=True)
    flat = tdec.flash_decode_attention(q_t, k_t[1], v_t[1], _t(lengths),
                                       ks_t[1], vs_t[1])
    for ours, theirs in zip(flat, (_own(acc_j, h, kv, d), _np(m_j),
                                   _np(l_j))):
        _close(ours, theirs, tol)
    for a, b in zip(flat, got):
        assert torch.equal(a, b)
    assert bool((flat[1][0] == -1e30).all()) \
        and float(flat[2][0].abs().max()) == 0


@pytest.mark.parametrize("page_tokens", [32, 16, 8])
def test_int8_paged_plain_equals_flat_plain_on_gathered_view(page_tokens):
    """int8 #3 == int8 #1 on the gathered view (codes and scales), bit for
    bit, at page sizes at and below the kernel's 64-row tile."""
    (kp, vp), (_, qt), _, table, lengths, h, kv = _int8_case(
        13, 32, "float32", page_tokens)
    q_t, _ = tdec._prep_query(qt[:, 0], 32)
    k_t, ks_t = tdec._split_paged(kp[1])
    v_t, vs_t = tdec._split_paged(vp[1])
    rows = _t(table).long()
    for layer in range(2):
        paged = tdec.flash_decode_attention_paged(
            q_t, k_t, v_t, layer, _t(table), _t(lengths), ks_t, vs_t)
        flat = tdec.flash_decode_attention(
            q_t, k_t[layer][rows].reshape(3, -1, kv * 32),
            v_t[layer][rows].reshape(3, -1, kv * 32), _t(lengths),
            ks_t[layer][rows].reshape(3, -1, kv),
            vs_t[layer][rows].reshape(3, -1, kv))
        for a, b in zip(paged, flat):
            assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["flat", "stacked", "paged"])
@pytest.mark.parametrize("dtype,tol", [("float32", dict(atol=1e-5,
                                                         rtol=1e-5)),
                                       ("bfloat16", BF16)])
def test_int8_appends_match_pallas(form, dtype, tol):
    """flash_decode_append, _stacked and _paged over int8 caches (the
    JAX signatures: dict leaves, ``_split_*`` views) against the JAX
    package's, f32 at test_kernel_plane.py's 1e-5."""
    (kp, vp), (qj, qt), ((knj, knt), (vnj, vnt)), table, lengths, h, kv = \
        _int8_case(14, 16, dtype)
    if form == "paged":
        out_j = jdec.flash_decode_append_paged(
            qj, jdec._split_paged(kp[0]), jdec._split_paged(vp[0]),
            jnp.int32(1), knj, vnj, jnp.asarray(table), jnp.asarray(lengths),
            interpret=True)
        out_t = tdec.flash_decode_append_paged(
            qt, tdec._split_paged(kp[1]), tdec._split_paged(vp[1]), 1, knt,
            vnt, _t(table), _t(lengths))
    else:
        def jrows(leaf):
            return {name: arr[1][jnp.asarray(table)].reshape(
                3, 128, *arr.shape[3:]) for name, arr in leaf.items()}

        def trows(leaf):
            return {name: arr[1][_t(table).long()].reshape(
                3, 128, *arr.shape[3:]) for name, arr in leaf.items()}
        kj, vj, kt, vt = jrows(kp[0]), jrows(vp[0]), trows(kp[1]), \
            trows(vp[1])
        if form == "flat":
            def grouped(leaf):
                return {"int8": leaf["int8"].reshape(3, 128, kv, 16),
                        "scale": leaf["scale"]}
            out_j = jdec.flash_decode_append(
                qj, grouped(kj), grouped(vj), knj, vnj, jnp.asarray(lengths),
                block_t=32, interpret=True)
            out_t = tdec.flash_decode_append(
                qt, grouped(kt), grouped(vt), knt, vnt, _t(lengths))
        else:
            def stack(leaf):
                return {name: arr[None] for name, arr in leaf.items()}
            out_j = jdec.flash_decode_append_stacked(
                qj, jdec._split_stacked(stack(kj)),
                jdec._split_stacked(stack(vj)), 0, knj, vnj,
                jnp.asarray(lengths), block_t=128, interpret=True)
            out_t = tdec.flash_decode_append_stacked(
                qt, tdec._split_stacked(stack(kt)),
                tdec._split_stacked(stack(vt)), 0, knt, vnt, _t(lengths))
    assert out_t.dtype == qt.dtype and out_t.shape == qt.shape
    _close(out_t.float(), _np(out_j), tol)
