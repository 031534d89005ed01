"""The decode forms #1-#3 on the split attention body, on their plain
versions (the CUDA body and its combine hold these on the card,
``test_torch_cuda.py`` and ``chip_smoke.py``):

- the split partials at one query token
  (``flash_decode_partials_reference``, the chunk verify's partials at
  S = 1) merged by the plain decode combine equal the unsplit plain
  decode stats, over bf16 and int8 caches, with f32 queries (float32
  1e-5: the merge reorders sums) and bf16 queries (held on the
  normalised output, as the card holds them);
- merged, they match the JAX package's flash_decode_attention_stacked
  and flash_decode_attention_paged in interpret mode at the tolerances
  of ``test_torch_kernels.py`` (float32 1e-4, bf16 2e-2);
- the paged partials equal the flat partials on the gathered view, bit
  for bit, at 64- and 16-token pages (splits are cut at positions,
  never pages);
- the split depends on the shapes only, and a length-0 row is neutral
  in every split and after the combine."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import quant as jq
from aiko_services_tpu.ops import pallas_decode as jdec
from aiko_services_tpu_torch.models import quant as tq
from aiko_services_tpu_torch.ops import flash_decode as tdec

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)
EXACT_ORDER = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(actual, expected, tol):
    np.testing.assert_allclose(np.asarray(actual, dtype=np.float64),
                               np.asarray(expected, dtype=np.float64), **tol)


def _normalised_error(got, want) -> float:
    """chip_smoke.py's measure of two (acc, m, l) triples."""
    (acc, m, l), (acc_w, m_w, l_w) = got, want
    live = (l_w > 0)[..., None]
    out = torch.where(live, acc / l[..., None], acc)
    out_w = torch.where(live, acc_w / l_w[..., None], acc_w)
    return max((out - out_w).abs().max().item(),
               (m - m_w).abs().max().item(),
               ((l - l_w).abs() / l_w.clamp(min=1.0)).max().item())


def _case(seed=0, d=32, int8=False, pt=64, b=3, kv=2, g=2, pps=10):
    """Two layers of page pools [2, b * pps + 1, pt, kv * d] scattered
    through a shuffled [b, pps] table (page 0 the trash page), the same
    rows gathered into a stacked [2, b, T, kv * d] cache, lengths 0,
    mid-tile and T - 1, and queries [b, 1, kv * g, d].  The int8 case
    quantizes the pools as kv_dtype="int8" stores them; both packages'
    leaves are kept (bit-equal codes and scales)."""
    rng = np.random.default_rng(seed)
    t = pps * pt
    pages = b * pps + 1
    raw = [rng.normal(size=(2, pages, pt, kv, d)).astype(np.float32)
           for _ in range(2)]
    table = (rng.permutation(pages - 1) + 1).reshape(b, pps).astype(np.int32)
    q = rng.normal(size=(b, 1, kv * g, d)).astype(np.float32)
    lengths = np.array([0, 200, t - 1][:b], dtype=np.int32)
    ours, theirs = [], []
    for side in raw:
        if int8:
            leaf_t = tq.quantize_kv(_t(side))
            leaf_j = jq.quantize_kv(jnp.asarray(side))
            ours.append((leaf_t["int8"].reshape(2, pages, pt, kv * d),
                         leaf_t["scale"][..., 0]))
            theirs.append((jnp.asarray(leaf_j["int8"]).reshape(
                2, pages, pt, kv * d), jnp.swapaxes(
                    jnp.asarray(leaf_j["scale"])[..., 0], -1, -2)))
        else:
            ours.append((_t(side.reshape(2, pages, pt, kv * d)), None))
            theirs.append((jnp.asarray(side.reshape(2, pages, pt, kv * d)),
                           None))
    return dict(q=q, table=table, lengths=lengths, ours=ours, theirs=theirs,
                b=b, t=t, kv=kv, d=d, h=kv * g, pt=pt)


def _stacked(x):
    """The pools' pages through the table as a stacked [2, B, T, ...]
    cache (payload and scales)."""
    rows = _t(x["table"]).long()
    return [tuple(None if part is None else
                  part[:, rows].reshape(2, x["b"], x["t"], part.shape[-1])
                  .contiguous() for part in side) for side in x["ours"]]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_decode_split_over_t_equals_unsplit(int8, q_dtype):
    x = _case(int8=int8)
    (k, ks), (v, vs) = (tuple(None if p is None else p[1] for p in side)
                        for side in _stacked(x))
    q = tdec._prep_query(_t(x["q"][:, 0]), 64)[0].to(q_dtype)
    lengths = _t(x["lengths"])
    splits, per_split = tdec.verify_splits(x["t"], x["b"], x["kv"])
    assert splits == 10 and per_split == 1        # a split a tile here
    parts = tdec.flash_decode_partials_reference(q, k, v, lengths, ks, vs)
    assert parts[0].shape == (x["b"], x["kv"], splits, 2, x["d"])
    # Splits past a row's length are neutral: all of row 0, and every
    # split of row 1 from position 256 on.
    assert torch.all(parts[1][0] == tdec.NEG_INF)
    assert torch.all(parts[2][1, :, 4:] == 0)
    assert torch.all(parts[0][1, :, 4:] == 0)
    merged = tdec.decode_combine_reference(*parts)
    whole = tdec.flash_decode_attention_reference(q, k, v, lengths, ks, vs)
    if q_dtype == torch.float32:
        for got, want in zip(merged, whole):
            _close(got, want, EXACT_ORDER)
    else:
        # bf16 queries round each weight to bf16 against its split's max,
        # the unsplit version against the row's: one-ulp flips add up in
        # the raw sums, so they are held on the normalised output.
        assert _normalised_error(merged, whole) <= BF16["atol"]
    assert torch.all(merged[0][0] == 0) and torch.all(merged[2][0] == 0)
    assert torch.all(merged[1][0] == tdec.NEG_INF)
    # The wrappers take these plain versions on a CPU tensor.
    for got, want in zip(tdec.decode_combine(*parts), merged):
        assert torch.equal(got, want)


def _own(x, h, kv, d):
    """The port's compact [B, H, hd] blocks of a block-diagonal
    [B, H, K*hd] TPU accumulator."""
    blocks = np.arange(h) // (h // kv)
    x = _np(x)
    return x.reshape(x.shape[0], h, kv, d)[:, np.arange(h), blocks]


# d = 32: scale 2^-2.5, f32 queries (Llama-3-8B's branch); d = 16: scale
# 1/4 folds into bf16 queries (the bf16 branch).
JAX_CASES = [(32, "float32", F32), (16, "bfloat16", BF16)]


@pytest.mark.parametrize("form", ["stacked", "paged"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d,dtype,tol", JAX_CASES)
def test_decode_split_matches_jax_kernels(form, int8, d, dtype, tol):
    """The split partials merged by the plain combine against the JAX
    package's stacked or paged decode kernel in interpret mode on the
    same cache (layer 1) and queries."""
    x = _case(seed=1, d=d, int8=int8)
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    q_j = jnp.asarray(x["q"][:, 0], jdtype)
    q_pad_j, _, _, _ = jdec._prep_query(q_j, x["h"], x["kv"], d)
    q_t, _ = tdec._prep_query(_t(x["q"][:, 0]).to(tdtype), d)
    lengths = x["lengths"]
    (kj, ksj), (vj, vsj) = x["theirs"]
    (k, ks), (v, vs) = _stacked(x)
    if form == "paged":
        theirs = jdec.flash_decode_attention_paged(
            q_pad_j, kj, vj, ksj, vsj, jnp.int32(1), jnp.asarray(x["table"]),
            jnp.asarray(lengths), interpret=True)
        (kp, ksp), (vp, vsp) = x["ours"]
        parts = tdec.flash_decode_partials_paged(
            q_t, kp, vp, 1, _t(x["table"]), _t(lengths), ksp, vsp)
    else:
        rows = jnp.asarray(x["table"])

        def gather(pool, scales=False):
            if pool is None:
                return None
            if scales:          # [L, P, K, pt] -> [L, B, K, T]
                out = pool[:, rows].transpose(0, 1, 3, 2, 4)
                return out.reshape(2, x["b"], x["kv"], x["t"])
            return pool[:, rows].reshape(2, x["b"], x["t"], -1)
        theirs = jdec.flash_decode_attention_stacked(
            q_pad_j, gather(kj), gather(vj), gather(ksj, True),
            gather(vsj, True), 1, jnp.asarray(lengths), block_t=128,
            interpret=True)
        parts = tdec.flash_decode_partials_stacked(
            q_t, k, v, 1, _t(lengths), ks, vs)
    acc, m, l = tdec.decode_combine_reference(*parts)
    acc_j, m_j, l_j = theirs
    _close(acc, _own(acc_j, x["h"], x["kv"], d), tol)
    _close(m, _np(m_j), tol)
    _close(l, _np(l_j), tol)
    assert bool((m[0] == -1e30).all()) and float(l[0].abs().max()) == 0


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("pt", [64, 16])
def test_decode_paged_partials_equal_flat_on_gathered_view(int8, pt):
    """The paged plain partials are the flat ones on the gathered rows,
    bit for bit, at page sizes at and below the 64-key tile."""
    x = _case(seed=2, int8=int8, pt=pt, pps=640 // pt)
    q = tdec._prep_query(_t(x["q"][:, 0]), 64)[0]
    (kp, ksp), (vp, vsp) = x["ours"]
    (k, ks), (v, vs) = _stacked(x)
    for layer in range(2):
        paged = tdec.flash_decode_partials_paged(
            q, kp, vp, layer, _t(x["table"]), _t(x["lengths"]), ksp, vsp)
        flat = tdec.flash_decode_partials_reference(
            q, k[layer], v[layer], _t(x["lengths"]),
            None if ks is None else ks[layer],
            None if vs is None else vs[layer])
        for got, want in zip(paged, flat):
            assert torch.equal(got, want)


@pytest.mark.parametrize("t_len,batch,n_kv,expected", [
    (2048, 8, 8, (8, 4)), (8192, 8, 8, (9, 15)), (2048, 1, 8, (32, 1)),
    (640, 3, 2, (10, 1))])
def test_decode_split_depends_on_shapes_only(t_len, batch, n_kv, expected):
    """The decode forms take the verify body's split rule, a function of
    (T, B, K) alone -- a captured launch replays it -- and two sets of
    lengths give partials of one shape (the same grid)."""
    assert list(inspect.signature(tdec.verify_splits).parameters) == [
        "t_len", "batch", "n_kv"]
    assert tdec.verify_splits(t_len, batch, n_kv) == expected
    x = _case(seed=3)
    q = tdec._prep_query(_t(x["q"][:, 0]), 64)[0]
    (k, _), (v, _) = _stacked(x)
    one = tdec.flash_decode_partials_reference(q, k[0], v[0],
                                               _t(x["lengths"]))
    other = tdec.flash_decode_partials_reference(
        q, k[0], v[0], torch.full((x["b"],), x["t"], dtype=torch.int32))
    assert [p.shape for p in one] == [p.shape for p in other]


@pytest.mark.parametrize("int8", [False, True])
def test_decode_length_zero_rows_are_neutral(int8):
    """Every row at length 0: every split neutral (acc 0, m -1e30, l 0),
    and so is the combine's output, which _combine_self then turns into
    the current token's own value."""
    x = _case(seed=4, int8=int8)
    (k, ks), (v, vs) = (tuple(None if p is None else p[0] for p in side)
                        for side in _stacked(x))
    q = tdec._prep_query(_t(x["q"][:, 0]), 32)[0]
    zero = torch.zeros((x["b"],), dtype=torch.int32)
    parts = tdec.flash_decode_partials_reference(q, k, v, zero, ks, vs)
    assert torch.all(parts[0] == 0) and torch.all(parts[2] == 0)
    assert torch.all(parts[1] == tdec.NEG_INF)
    acc, m, l = tdec.decode_combine_reference(*parts)
    assert torch.all(acc == 0) and torch.all(l == 0)
    assert torch.all(m == tdec.NEG_INF)
    rng = np.random.default_rng(5)
    k_new, v_new = (_t(rng.normal(size=(x["b"], 1, x["kv"], x["d"]))
                       .astype(np.float32)) for _ in range(2))
    out = tdec._combine_self(acc, m, l, _t(x["q"][:, 0]), k_new, v_new,
                             x["d"] ** -0.5)
    want = v_new[:, 0].repeat_interleave(x["h"] // x["kv"], dim=1)
    _close(out, want, EXACT_ORDER)
