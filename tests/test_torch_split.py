"""The two split decompositions of the port's kernels, on their plain
versions (the CUDA bodies hold these on the card, ``test_torch_cuda.py``
and ``chip_smoke.py``):

- the chunk-verify body split over T at the kernel's boundaries
  (``verify_splits``: 64-key tiles, a function of the static shapes) and
  merged by the plain combine equals the unsplit plain version (float32,
  1e-5: the merge reorders sums) and, merged with the chunk's own k/v as
  ``flash_verify_append`` does, the JAX package's ``flash_verify_append``
  run in interpret mode at the tolerances of ``test_torch_loop.py``'s
  verify parity tests (1e-5, int8 1e-4);
- the int8 matmul's decode route split over D (``decode_splits``) and
  merged by the plain combine is bit-exact on grid inputs (every partial
  an exact float) and equal to ``int8_matmul_reference``, and within the
  card gate's 2^-7 of max |out| on random inputs;
- the split-count rules themselves: about 2 x 132 blocks or more at
  every decode leaf of Llama-3-8B, one split for its unembed, and no
  dependence on the cache's lengths."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import quant as jq
from aiko_services_tpu.ops import pallas_decode as jdec
from aiko_services_tpu_torch.models import quant as tq
from aiko_services_tpu_torch.ops import flash_decode as tdec
from aiko_services_tpu_torch.ops import int8_matmul as tmm

F32 = dict(atol=1e-5, rtol=1e-5)
LOOSE = dict(atol=1e-4, rtol=1e-4)
INT8_MATMUL_TOL = 2.0 ** -7

# Llama-3-8B (dim 4,096, 8 kv heads of 128, hidden 14,336, vocab 128,256).
LEAVES = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
          "wo": (4096, 4096), "w_gate": (4096, 14_336),
          "w_up": (4096, 14_336), "w_down": (14_336, 4096)}
UNEMBED = (4096, 128_256)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(actual, expected, tol):
    np.testing.assert_allclose(np.asarray(actual, dtype=np.float64),
                               np.asarray(expected, dtype=np.float64), **tol)


def _verify_case(seed=0, b=3, s=5, kv=2, g=2, hd=16, t=640, int8=False):
    """A stacked cache of t positions (10 tiles) with starts 0, mid-tile
    and t - 1, and scaled f32 queries; the int8 case quantizes the cache
    as kv_dtype="int8" stores it."""
    rng = np.random.default_rng(seed)
    starts = np.array([0, 200, t - 1][:b], dtype=np.int32)
    q = rng.normal(size=(b, s, kv * g, hd)).astype(np.float32)
    raw = [rng.normal(size=(2, b, t, kv, hd)).astype(np.float32)
           for _ in range(2)]
    scales = [None, None]
    caches = [_t(side.reshape(2, b, t, kv * hd)) for side in raw]
    if int8:
        for i, side in enumerate(raw):
            leaf = tq.quantize_kv(_t(side))
            caches[i] = leaf["int8"].reshape(2, b, t, kv * hd)
            scales[i] = leaf["scale"][..., 0]
    return dict(q=q, starts=starts, caches=caches, scales=scales, raw=raw,
                s=s, kv=kv, hd=hd, t=t, b=b)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_verify_split_over_t_equals_unsplit(int8, q_dtype):
    x = _verify_case(int8=int8)
    q = tdec._prep_query(_t(x["q"]), 64)[0].to(q_dtype)
    k, v = (cache[1] for cache in x["caches"])
    ks, vs = (None if scale is None else scale[1] for scale in x["scales"])
    starts = _t(x["starts"])
    splits, per_split = tdec.verify_splits(x["t"], x["b"], x["kv"])
    assert splits == 10 and per_split == 1        # a split a tile here
    parts = tdec.flash_verify_partials_reference(q, k, v, starts, ks, vs)
    assert parts[0].shape == (x["b"], x["kv"], splits, x["s"] * 2, x["hd"])
    # A split past a row's start is neutral: the start-0 row, and every
    # split of row 1 from position 256 on.
    assert torch.all(parts[1][0] == tdec.NEG_INF)
    assert torch.all(parts[2][1, :, 4:] == 0)
    merged = tdec.verify_combine_reference(*parts, x["s"])
    whole = tdec.flash_verify_attention_reference(q, k, v, starts, ks, vs)
    if q_dtype == torch.float32:
        for got, want in zip(merged, whole):
            _close(got, want, F32)
    else:
        # bf16 queries round each weight to bf16 against its split's max,
        # the unsplit version against the row's: held as the card holds
        # them (chip_smoke.py's BF16_TOL on the normalised output, m and
        # relative l), since one-ulp flips add up in the raw sums.
        (acc, m, l), (acc_w, m_w, l_w) = merged, whole
        live = (l_w > 0)[..., None]
        out = torch.where(live, acc / l[..., None], acc)
        out_w = torch.where(live, acc_w / l_w[..., None], acc_w)
        assert max((out - out_w).abs().max().item(),
                   (m - m_w).abs().max().item(),
                   ((l - l_w).abs() / l_w.clamp(min=1.0)).max().item()) \
            <= 2e-2
    assert torch.all(merged[0][0] == 0) and torch.all(merged[2][0] == 0)
    assert torch.all(merged[1][0] == tdec.NEG_INF)


@pytest.mark.parametrize("int8", [False, True])
def test_verify_split_matches_jax_flash_verify_append(int8):
    """The split cache part, merged by the plain combine and then with the
    chunk's own k/v (``_combine_chunk``, as ``flash_verify_append``
    does), against the JAX package's flash_verify_append in interpret
    mode on the same cache, queries and chunk."""
    x = _verify_case(seed=1, int8=int8)
    rng = np.random.default_rng(2)
    b, s, kv, hd, t = x["b"], x["s"], x["kv"], x["hd"], x["t"]
    k_new = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v_new = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    positions = np.minimum(x["starts"][:, None] + np.arange(s)[None, :],
                           t - 1).astype(np.int32)
    layer = 1
    q = _t(x["q"])
    q_scaled, scale = tdec._prep_query(q, hd)
    k, v = x["caches"]
    ks, vs = x["scales"]
    parts = tdec.flash_verify_partials_reference(
        q_scaled, k[layer], v[layer], _t(x["starts"]),
        None if ks is None else ks[layer], None if vs is None else vs[layer])
    acc, m, l = tdec.verify_combine_reference(*parts, s)
    ours = tdec._combine_chunk(acc, m, l, q, _t(k_new), _t(v_new),
                               _t(positions), scale)
    if int8:
        views = []
        for raw in x["raw"]:
            leaf = jq.quantize_kv(jnp.asarray(raw))
            codes = np.asarray(leaf["int8"]).reshape(2, b, t, kv * hd)
            views.append((jnp.asarray(codes), jnp.asarray(
                np.asarray(leaf["scale"])[..., 0].swapaxes(-1, -2))))
    else:
        views = [(jnp.asarray(cache.numpy()), None) for cache in (k, v)]
    theirs = jdec.flash_verify_append(
        jnp.asarray(x["q"]), *views, jnp.int32(layer), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(x["starts"]),
        jnp.asarray(positions), interpret=True)
    _close(ours.numpy(), np.asarray(theirs), LOOSE if int8 else F32)


def test_verify_paged_partials_equal_stacked_on_gathered_view():
    """The paged plain partials are the stacked ones on the gathered rows,
    bit for bit, at 64- and 16-token pages: the split is over positions
    of the logical extent, never pages."""
    x = _verify_case(seed=3)
    q = tdec._prep_query(_t(x["q"]), 64)[0]
    k = x["caches"][0][1]
    v = x["caches"][1][1]
    b, t, c = x["b"], x["t"], k.shape[-1]
    for pt in (64, 16):
        pps = t // pt
        order = torch.randperm(b * pps, generator=torch.Generator()
                               .manual_seed(pt)) + 1
        table = order.reshape(b, pps).to(torch.int32)
        pools = []
        for side in (k, v):
            pool = torch.zeros((1, b * pps + 1, pt, c))
            pool[0, order] = side.reshape(b * pps, pt, c)
            pools.append(pool)
        paged = tdec.flash_verify_partials_paged(q, *pools, 0, table,
                                                 _t(x["starts"]))
        stacked = tdec.flash_verify_partials_stacked(
            q, k[None], v[None], 0, _t(x["starts"]))
        for got, want in zip(paged, stacked):
            assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_int8_split_over_d_is_exact_on_grid_inputs(name):
    """Each decode leaf at M 8: the split partials merged in split order
    equal int8_matmul_reference bit for bit on integer x and power-of-two
    scales, at Llama-3-8B's D (F cut to 256 columns, which the split of
    D does not see: the rule is taken at the leaf's own F)."""
    d, f = LEAVES[name]
    gen = torch.Generator().manual_seed(len(name))
    cols = 256
    w = torch.randint(-127, 128, (d, cols), generator=gen, dtype=torch.int8)
    scale = 2.0 ** torch.randint(-10, -4, (1, cols), generator=gen).float()
    x = torch.randint(-3, 4, (8, d), generator=gen).to(torch.bfloat16)
    splits, per_split = tmm.decode_splits(d, f)
    span = per_split * tmm.DECODE_TILE_K
    partial = torch.stack([x[:, z * span:(z + 1) * span].float()
                           @ w[z * span:(z + 1) * span].float()
                           for z in range(splits)])
    assert splits > 1
    merged = tmm.int8_combine_reference(partial, scale)
    assert torch.equal(merged, tmm.int8_matmul_reference(x, w, scale))


@pytest.mark.parametrize("d,f", [(328, 400), (1024, 3984), (4096, 1024)])
def test_int8_split_partials_match_reference(d, f):
    """The plain partials at the rule's own split (grid inputs exact,
    random inputs within 2^-7 of max |out|), and the combine's wrapper
    runs its plain version on a CPU tensor."""
    gen = torch.Generator().manual_seed(d + f)
    w = torch.randint(-127, 128, (d, f), generator=gen, dtype=torch.int8)
    scale = 2.0 ** torch.randint(-8, -2, (1, f), generator=gen).float()
    x = torch.randint(-3, 4, (8, d), generator=gen).to(torch.bfloat16)
    partial = tmm.int8_matmul_partials_reference(x, w)
    assert partial.shape == (tmm.decode_splits(d, f)[0], 8, f)
    assert torch.equal(tmm.int8_combine(partial, scale),
                       tmm.int8_matmul_reference(x, w, scale))
    leaf = tq.quantize_weight(torch.randn((d, f), generator=gen))
    x = torch.randn((8, d), generator=gen).to(torch.bfloat16)
    got = tmm.int8_combine(tmm.int8_matmul_partials_reference(
        x, leaf["int8"]), leaf["scale"]).float()
    want = tmm.int8_matmul_reference(x, leaf["int8"], leaf["scale"]).float()
    assert ((got - want).abs().max() / want.abs().max()).item() \
        <= INT8_MATMUL_TOL


@pytest.mark.parametrize("name", sorted(LEAVES))
def test_decode_split_rule_fills_the_card(name):
    d, f = LEAVES[name]
    splits, per_split = tmm.decode_splits(d, f)
    steps = -(-d // tmm.DECODE_TILE_K)
    assert -(-steps // per_split) == splits          # every step covered
    assert (splits - 1) * per_split < steps          # no empty split
    assert -(-f // tmm.DECODE_TILE_N) * splits >= 2 * tmm.CARD_SMS


def test_decode_split_rule_keeps_the_unembed_whole():
    assert tmm.decode_splits(*UNEMBED) == (1, 32)


@pytest.mark.parametrize("t_len,batch,n_kv", [(2048, 8, 8), (2048, 1, 8),
                                              (8192, 8, 8), (128, 3, 2),
                                              (64, 1, 1)])
def test_verify_split_rule_is_a_function_of_shapes(t_len, batch, n_kv):
    """The verify split depends on (t_len, batch, n_kv) alone -- no
    lengths argument, so a captured launch replays it -- covers every
    tile with no empty split, and at the serving shape gives 8 splits of
    4 tiles (512 blocks)."""
    assert list(inspect.signature(tdec.verify_splits).parameters) == [
        "t_len", "batch", "n_kv"]
    splits, per_split = tdec.verify_splits(t_len, batch, n_kv)
    tiles = -(-t_len // tdec.VERIFY_TILE)
    assert -(-tiles // per_split) == splits
    assert (splits - 1) * per_split < tiles
    assert batch * n_kv * splits >= min(2 * tdec.CARD_SMS, batch * n_kv
                                        * tiles)
    if (t_len, batch, n_kv) == (2048, 8, 8):
        assert (splits, per_split) == (8, 4)


def test_verify_partials_do_not_depend_on_starts():
    """Two sets of starts give partials of one shape (the same grid);
    only their contents differ."""
    x = _verify_case(seed=4)
    q = tdec._prep_query(_t(x["q"]), 64)[0]
    k, v = (cache[0] for cache in x["caches"])
    one = tdec.flash_verify_partials_reference(q, k, v, _t(x["starts"]))
    other = tdec.flash_verify_partials_reference(
        q, k, v, torch.full((x["b"],), x["t"], dtype=torch.int32))
    assert [p.shape for p in one] == [p.shape for p in other]
