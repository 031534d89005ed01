"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes (``chip_smoke.py`` repeats this at the serving
path's shapes).  Imports no JAX, so it runs on the card machine:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py

Without a card every test here skips."""

import pytest
import torch

from aiko_services_tpu_torch.models.quant import quantize_kv, quantize_weight
from aiko_services_tpu_torch.ops import flash_attention as tatt
from aiko_services_tpu_torch.ops import flash_decode as tdec
from aiko_services_tpu_torch.ops.int8_matmul import (
    decode_splits, int8_combine, int8_combine_reference, int8_matmul,
    int8_matmul_reference)
from aiko_services_tpu_torch.ops.topk import topk, topk_reference

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device):
    """Each CUDA kernel against its plain version on the card, at small
    shapes (chip_smoke.py repeats this at the serving shapes)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    k = torch.randn((2, 3, 256, 2 * 128), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    v = torch.randn_like(k, dtype=torch.float32).to(torch.bfloat16)
    q = torch.randn((3, 8, 128), generator=gen, device=cuda_device)
    q_scaled, _ = tdec._prep_query(q.to(torch.bfloat16), 128)
    lengths = torch.tensor([0, 1, 255], dtype=torch.int32,
                           device=cuda_device)
    got = tdec.flash_decode_attention_stacked(q_scaled, k, v, 1, lengths)
    want = tdec.flash_decode_attention_stacked_reference(q_scaled, k, v, 1,
                                                         lengths)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **F32)
    qa = torch.randn((1, 40, 8, 128), generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    ka = k[1, :1].reshape(1, 256, 2, 128)
    va = v[1, :1].reshape(1, 256, 2, 128)
    torch.testing.assert_close(
        tatt.flash_attention(qa, ka, va, q_offset=100).float(),
        tatt.flash_attention_reference(qa, ka, va, 100).float(), **BF16)
    x = torch.randn((3, 5000), generator=gen, device=cuda_device)
    x[0, ::7] = 3.0
    for kk in (1, 50):
        got_v, got_i = topk(x, kk)
        ref_v, ref_i = topk_reference(x, kk)
        assert torch.equal(got_v, ref_v) and torch.equal(got_i, ref_i)


@pytest.mark.cuda
@pytest.mark.parametrize("page_tokens", [64, 16, 8])
def test_paged_kernel_bitwise_matches_flat_kernel(cuda_device, page_tokens):
    """Kernel #3 walking a scattered page table is bitwise equal to
    kernel #1 on the gathered contiguous view (acc, m and l), at page
    sizes at and below the kernel's 64-row tile, for f32 and bf16
    queries; and #3 holds its plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    b, pps, kv, hd, h = 3, 6, 2, 128, 8
    pages = b * pps + 1
    pool_k = torch.randn((2, pages, page_tokens, kv * hd), generator=gen,
                         device=cuda_device).to(torch.bfloat16)
    pool_v = torch.randn_like(pool_k, dtype=torch.float32).to(torch.bfloat16)
    order = torch.randperm(pages - 1, generator=gen, device=cuda_device) + 1
    table = order.reshape(b, pps).to(torch.int32)
    t = pps * page_tokens
    lengths = torch.tensor([t, 1, t - 5], dtype=torch.int32,
                           device=cuda_device)
    q = torch.randn((b, h, hd), generator=gen, device=cuda_device)
    for q_in in (tdec._prep_query(q, hd)[0],
                 tdec._prep_query(q.to(torch.bfloat16), 64)[0]):
        layer = 1
        paged = tdec.flash_decode_attention_paged(q_in, pool_k, pool_v,
                                                  layer, table, lengths)
        flat = tdec.flash_decode_attention(
            q_in, pool_k[layer][table.long()].reshape(b, t, kv * hd),
            pool_v[layer][table.long()].reshape(b, t, kv * hd), lengths)
        plain = tdec.flash_decode_attention_paged_reference(
            q_in, pool_k, pool_v, layer, table, lengths)
        torch.cuda.synchronize()
        for got, same, want in zip(paged, flat, plain):
            assert torch.equal(got, same)
            torch.testing.assert_close(got, want, **(
                F32 if q_in.dtype == torch.float32 else BF16))


def _int8_pool(shape, gen, device):
    """A [.., K*hd] int8 cache side: (codes, [.., K] f32 scales)."""
    raw = torch.randn(shape, generator=gen, device=device)
    leaf = quantize_kv(raw.reshape(*shape[:-1], 2, shape[-1] // 2))
    return leaf["int8"].reshape(shape), leaf["scale"][..., 0]


@pytest.mark.cuda
@pytest.mark.parametrize("page_tokens", [64, 16, 8])
def test_int8_decode_kernels_match_plain_and_each_other(cuda_device,
                                                        page_tokens):
    """The int8 payload of the decode body: #3 over int8 pools with their
    scale pools is bitwise equal to #1 on the gathered codes and scales,
    #2 on the gathered view as a stacked cache equals #1 too, and each
    holds its plain version, for f32 and bf16 queries."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    b, pps, kv, hd, h = 3, 6, 2, 128, 8
    pages = b * pps + 1
    k_pool, ks_pool = _int8_pool((2, pages, page_tokens, kv * hd), gen,
                                 cuda_device)
    v_pool, vs_pool = _int8_pool((2, pages, page_tokens, kv * hd), gen,
                                 cuda_device)
    order = torch.randperm(pages - 1, generator=gen, device=cuda_device) + 1
    table = order.reshape(b, pps).to(torch.int32)
    t = pps * page_tokens
    lengths = torch.tensor([t, 1, t - 5], dtype=torch.int32,
                           device=cuda_device)
    q = torch.randn((b, h, hd), generator=gen, device=cuda_device)
    rows = table.long()
    for q_in in (tdec._prep_query(q, hd)[0],
                 tdec._prep_query(q.to(torch.bfloat16), 64)[0]):
        layer = 1
        gathered = [pool[layer][rows].reshape(b, t, -1)
                    for pool in (k_pool, v_pool, ks_pool, vs_pool)]
        paged = tdec.flash_decode_attention_paged(
            q_in, k_pool, v_pool, layer, table, lengths, ks_pool, vs_pool)
        flat = tdec.flash_decode_attention(q_in, gathered[0], gathered[1],
                                           lengths, gathered[2], gathered[3])
        stacked = tdec.flash_decode_attention_stacked(
            q_in, *(g[None].contiguous() for g in gathered[:2]), 0, lengths,
            *(g[None].contiguous() for g in gathered[2:]))
        plain = tdec.flash_decode_attention_paged_reference(
            q_in, k_pool, v_pool, layer, table, lengths, ks_pool, vs_pool)
        torch.cuda.synchronize()
        for got, same, also, want in zip(paged, flat, stacked, plain):
            assert torch.equal(got, same) and torch.equal(same, also)
            torch.testing.assert_close(got, want, **(
                F32 if q_in.dtype == torch.float32 else BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [400, 3984, 15376])
@pytest.mark.parametrize("m", [8, 17, 40, 100, 512, 513])
def test_int8_matmul_kernel_matches_plain(cuda_device, m, f):
    """Kernel #5 at decode-sized M (the M <= 16 route) and at the
    admission route's M (verify forward 40, prompt chunks 512 and 513):
    exact on grid inputs (integer x, power-of-two scales), within one
    bf16 rounding of the output on random inputs; D and F off the tile
    sizes, F picking each of the admission route's three tiles."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    d = 328
    w = torch.randint(-127, 128, (d, f), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    scale = 2.0 ** torch.randint(-8, -2, (1, f), generator=gen,
                                 device=cuda_device).float()
    x = torch.randint(-3, 4, (m, d), generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    assert torch.equal(int8_matmul(x, w, scale),
                       int8_matmul_reference(x, w, scale))
    leaf = quantize_weight(torch.randn((d, f), generator=gen,
                                       device=cuda_device))
    x = torch.randn((m, d), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    got = int8_matmul(x, leaf["int8"], leaf["scale"])
    want = int8_matmul_reference(x, leaf["int8"], leaf["scale"])
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=1e-2)


def _attention_inputs(gen, device, dtype, b, s, t, kv, groups, d):
    """q [b, s, kv * groups, d] and k/v [b, t, kv, d] as strided views of
    a cache row [b, t + 24, kv * d] (the serving path's layout)."""
    q = torch.randn((b, s, kv * groups, d), generator=gen, device=device)
    rows = [torch.randn((b, t + 24, kv * d), generator=gen, device=device)
            .to(dtype) for _ in range(2)]
    k, v = (row[:, :t].view(b, t, kv, d) for row in rows)
    return q.to(dtype), k, v


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [40, 512, 513])
@pytest.mark.parametrize("q_offset", [0, 100, 1536])
def test_flash_attention_tensor_cores_match_plain(cuda_device, q_offset, s,
                                                  d, groups):
    """The bf16 tensor-core body of #4 against its plain version: chunks
    that are and are not a multiple of the row block, at the start of a
    row and deep in it, T = q_offset + s + 37 (not a multiple of the
    128-key tile), both head dims and every accepted group size."""
    gen = torch.Generator(device=cuda_device).manual_seed(q_offset + s + d)
    t = q_offset + s + 37
    q, k, v = _attention_inputs(gen, cuda_device, torch.bfloat16, 2, s, t,
                                2, groups, d)
    got = tatt.flash_attention(q, k, v, q_offset=q_offset)
    want = tatt.flash_attention_reference(q, k, v, q_offset)
    torch.testing.assert_close(got.float(), want.float(), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 4, 8])
def test_flash_attention_f32_keeps_fma_body(cuda_device, groups):
    """f32 inputs take the FMA body (no TF32 rounding): within F32 of the
    plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(groups)
    q, k, v = _attention_inputs(gen, cuda_device, torch.float32, 1, 77, 300,
                                2, groups, 64)
    got = tatt.flash_attention(q, k, v, q_offset=200)
    want = tatt.flash_attention_reference(q, k, v, 200)
    torch.testing.assert_close(got, want, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("page_tokens", [64, 16])
@pytest.mark.parametrize("int8", [False, True])
def test_verify_kernels_match_plain_and_each_other(cuda_device, page_tokens,
                                                   int8):
    """The chunk-verify kernel: the paged form walking a scattered table is
    bitwise equal to the stacked form on the gathered view, and both hold
    the plain version, for f32 and bf16 queries, over bf16 and int8
    caches, with starts 0, 1, mid-page and the last position."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    b, pps, kv, hd, h, s = 4, 5, 2, 128, 8, 5
    pages = b * pps + 1
    t = pps * page_tokens
    shape = (2, pages, page_tokens, kv * hd)
    if int8:
        (k_pool, ks_pool), (v_pool, vs_pool) = (
            _int8_pool(shape, gen, cuda_device) for _ in range(2))
    else:
        k_pool, v_pool = (torch.randn(shape, generator=gen,
                                      device=cuda_device).to(torch.bfloat16)
                          for _ in range(2))
        ks_pool = vs_pool = None
    order = torch.randperm(pages - 1, generator=gen, device=cuda_device) + 1
    table = order.reshape(b, pps).to(torch.int32)
    starts = torch.tensor([0, 1, t // 2 + 3, t - 1], dtype=torch.int32,
                          device=cuda_device)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda_device)
    rows = table.long()

    def stacked(pool):
        return None if pool is None else \
            pool[:, rows].reshape(2, b, t, -1).contiguous()
    for q_in in (tdec._prep_query(q, hd)[0],
                 tdec._prep_query(q.to(torch.bfloat16), 64)[0]):
        paged = tdec.flash_verify_attention_paged(
            q_in, k_pool, v_pool, 1, table, starts, ks_pool, vs_pool)
        flat = tdec.flash_verify_attention_stacked(
            q_in, stacked(k_pool), stacked(v_pool), 1, starts,
            stacked(ks_pool), stacked(vs_pool))
        plain = tdec.flash_verify_attention_paged_reference(
            q_in, k_pool, v_pool, 1, table, starts, ks_pool, vs_pool)
        torch.cuda.synchronize()
        for got, same, want in zip(paged, flat, plain):
            assert torch.equal(got, same)
            torch.testing.assert_close(got, want, **(
                F32 if q_in.dtype == torch.float32 else BF16))
        assert paged[0][0].abs().max() == 0 and (paged[1][0] == -1e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode,page_tokens", [("off", 0), ("ngram", 16),
                                              ("draft", 0)])
def test_graph_replayed_loop_block_equals_eager(cuda_device, mode,
                                                page_tokens):
    """One decode_loop block replayed from its captured CUDA graph equals
    the same block run eagerly at temperature 0: emitted tokens, every
    carry and the cache, on the decode or verify kernels (head_dim 64,
    bf16), with the launch counters advanced by the captured launches."""
    import dataclasses

    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.loop_graph import LoopRunner
    from aiko_services_tpu_torch.models.paged import init_paged_cache
    from aiko_services_tpu_torch.models.quant import draft_params
    config = dataclasses.replace(
        llama.LlamaConfig.tiny(vocab_size=512, max_seq=128), dim=256,
        hidden_dim=512, decode_attention="flash")
    params = llama.init_params(0, config, device=cuda_device)
    draft = draft_params(params) if mode == "draft" else None
    b, ring = 4, 12
    gen = torch.Generator(device=cuda_device).manual_seed(6)

    def cache():
        if page_tokens:
            out = init_paged_cache(config, b, 128, page_tokens,
                                   device=cuda_device)
            out["page_table"].copy_(torch.arange(
                1, b * 128 // page_tokens + 1, dtype=torch.int32,
                device=cuda_device).reshape(b, -1))
        else:
            out = llama.init_cache(config, b, device=cuda_device)
        for side in ("k", "v"):
            out[side].copy_(torch.randn(out[side].shape, generator=gen,
                                        device=cuda_device) * 0.5)
        return out
    eager_cache = cache()
    graph_cache = {name: tensor.clone() for name, tensor in
                   eager_cache.items()}
    width = 8 if mode == "ngram" else 1
    inputs = {
        "tokens": torch.tensor([5, 9, 2, 7], dtype=torch.int32),
        "lengths": torch.tensor([10, 50, 100, 0], dtype=torch.int32),
        "active": torch.tensor([True, True, True, False]),
        "budget": torch.tensor([12, 5, 12, 0], dtype=torch.int32),
        "temperatures": torch.zeros(b),
        "eos": torch.full((b, 1), -1, dtype=torch.int32),
        "history": torch.randint(0, 9, (b, width), dtype=torch.int32)}
    options = dict(ring=ring, speculative=mode, spec_tokens=3,
                   spec_window=8, top_k=0)
    dev = {name: value.to(cuda_device) for name, value in inputs.items()}
    eager = llama.decode_loop(
        params, config, dev["tokens"], eager_cache, dev["lengths"],
        dev["active"], dev["budget"], dev["temperatures"], dev["eos"],
        dev["history"], torch.Generator(device=cuda_device).manual_seed(0),
        draft=draft, **options)
    runner = LoopRunner(params, config, batch=b, draft=draft,
                        generator=torch.Generator(device=cuda_device)
                        .manual_seed(0), history_width=width,
                        device=cuda_device, **options)
    for name, value in inputs.items():
        runner.upload(name, value.numpy())
    before = tdec.flash_verify_attention_stacked.launches \
        + tdec.flash_verify_attention_paged.launches \
        + tdec.flash_decode_attention_stacked.launches \
        + tdec.flash_decode_attention_paged.launches
    replayed = runner.run(graph_cache)
    torch.cuda.synchronize()
    after = tdec.flash_verify_attention_stacked.launches \
        + tdec.flash_verify_attention_paged.launches \
        + tdec.flash_decode_attention_stacked.launches \
        + tdec.flash_decode_attention_paged.launches
    assert runner.captures == 1 and runner.replays == 1
    # warm-up (one iteration, eager) + the replayed block's launches
    assert after - before >= (ring - options["spec_tokens"]
                              if mode != "off" else ring) * config.n_layers
    names = ("emitted", "counts", "tokens", "lengths", "active", "budget",
             "history", None, "accepted", "drafted", "steps")
    want = {name: value for name, value in zip(names, eager) if name}
    for row in range(b):
        count = int(want["counts"][row])
        assert torch.equal(replayed["emitted"][row, :count],
                           want["emitted"][row, :count])
    for name in names[1:]:
        if name:
            assert torch.equal(replayed[name], want[name]), name
    assert int(want["counts"][1]) == 5 and int(want["counts"][3]) == 0
    # Every position but the trash one (several clamped writes land there,
    # in no fixed order).
    for side in ("k", "v"):
        got, ref = graph_cache[side], eager_cache[side]
        if page_tokens:
            rows = graph_cache["page_table"].long()
            got = got[:, rows].reshape(config.n_layers, b, 128, -1)
            ref = ref[:, rows].reshape(config.n_layers, b, 128, -1)
        assert torch.equal(got[:, :, :127], ref[:, :, :127])


def _normalised_error(got, want) -> float:
    """chip_smoke.py's measure of two (acc, m, l) triples: the largest of
    the normalised-output, running-max and relative-denominator
    differences."""
    (acc, m, l), (acc_w, m_w, l_w) = got, want
    live = (l_w > 0)[..., None]
    out = torch.where(live, acc / l[..., None], acc)
    out_w = torch.where(live, acc_w / l_w[..., None], acc_w)
    return max((out - out_w).abs().max().item(),
               (m - m_w).abs().max().item(),
               ((l - l_w).abs() / l_w.clamp(min=1.0)).max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("s,groups", [(1, 4), (2, 4), (5, 4), (9, 4),
                                      (9, 8)])
@pytest.mark.parametrize("int8", [False, True])
def test_verify_kernel_every_query_width(cuda_device, s, groups, int8):
    """S * G = 4, 8, 20, 36 and 72 queries a block (the wgmma widths 8,
    8, 24, 40 and 72): the body split over T and its combine against the
    plain version (f32 and bf16 queries), the paged form bitwise equal
    to the stacked one, and the combine kernel against the plain combine
    on the body's own partials."""
    gen = torch.Generator(device=cuda_device).manual_seed(10 * s + groups)
    b, pps, pt, kv, hd = 3, 12, 64, 2, 128
    h, t = kv * groups, pps * pt
    pages = b * pps + 1
    shape = (1, pages, pt, kv * hd)
    if int8:
        (k_pool, ks_pool), (v_pool, vs_pool) = (
            _int8_pool(shape, gen, cuda_device) for _ in range(2))
    else:
        k_pool, v_pool = (torch.randn(shape, generator=gen,
                                      device=cuda_device).to(torch.bfloat16)
                          for _ in range(2))
        ks_pool = vs_pool = None
    table = (torch.randperm(pages - 1, generator=gen, device=cuda_device)
             + 1).reshape(b, pps).to(torch.int32)
    starts = torch.tensor([0, 300, t - 1], dtype=torch.int32,
                          device=cuda_device)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda_device)

    def stacked(pool):
        return None if pool is None else \
            pool[:, table.long()].reshape(1, b, t, -1).contiguous()
    for q_in in (tdec._prep_query(q, hd)[0],
                 tdec._prep_query(q.to(torch.bfloat16), 64)[0]):
        paged = tdec.flash_verify_attention_paged(
            q_in, k_pool, v_pool, 0, table, starts, ks_pool, vs_pool)
        flat = tdec.flash_verify_attention_stacked(
            q_in, stacked(k_pool), stacked(v_pool), 0, starts,
            stacked(ks_pool), stacked(vs_pool))
        plain = tdec.flash_verify_attention_paged_reference(
            q_in, k_pool, v_pool, 0, table, starts, ks_pool, vs_pool)
        parts = tdec.flash_verify_partials_paged(
            q_in, k_pool, v_pool, 0, table, starts, ks_pool, vs_pool)
        merged = tdec.verify_combine(*parts, s)
        merged_plain = tdec.verify_combine_reference(*parts, s)
        torch.cuda.synchronize()
        for got, same in zip(paged, flat):
            assert torch.equal(got, same)
        if q_in.dtype == torch.float32:
            for got, want in zip(paged, plain):
                torch.testing.assert_close(got, want, **F32)
        else:
            # bf16 weights round against each split's running max, the
            # plain version's against the row's: the raw sums of a row
            # cut into 12 splits differ by one-ulp flips, so bf16 queries
            # are held as chip_smoke.py holds them -- BF16 on the
            # normalised output, m and relative l.
            assert _normalised_error(paged, plain) <= BF16["atol"]
        for got, want in zip(merged, merged_plain):
            torch.testing.assert_close(got, want, **F32)
        assert paged[0][0].abs().max() == 0 and (paged[1][0] == -1e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d,f", [(4096, 4096), (4096, 1024), (4096, 14_336),
                                 (14_336, 4096)])
def test_int8_decode_route_split_at_leaf_shapes(cuda_device, d, f):
    """The M <= 16 route at Llama-3-8B's decode leaves (M 8), split over
    D: exact on grid inputs, its combine kernel exactly the plain combine
    on the same partials."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + f)
    assert decode_splits(d, f)[0] > 1
    w = torch.randint(-127, 128, (d, f), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    scale = 2.0 ** torch.randint(-10, -4, (1, f), generator=gen,
                                 device=cuda_device).float()
    x = torch.randint(-3, 4, (8, d), generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    assert torch.equal(int8_matmul(x, w, scale),
                       int8_matmul_reference(x, w, scale))
    partial = torch.randn((decode_splits(d, f)[0], 8, f), generator=gen,
                          device=cuda_device)
    assert torch.equal(int8_combine(partial, scale),
                       int8_combine_reference(partial, scale))


@pytest.mark.cuda
def test_split_kernels_replay_in_a_graph(cuda_device):
    """The verify body with its combine, and the int8 decode route with
    its combine, captured in one CUDA graph: a replay equals the eager
    calls bit for bit (scratch comes from the graph's pool; the splits
    depend on shapes only)."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    b, pps, pt, kv, hd, h, s = 4, 8, 64, 2, 128, 8, 5
    pages = b * pps + 1
    k_pool, v_pool = (torch.randn((1, pages, pt, kv * hd), generator=gen,
                                  device=cuda_device).to(torch.bfloat16)
                      for _ in range(2))
    table = (torch.arange(b * pps, device=cuda_device) + 1).reshape(
        b, pps).to(torch.int32)
    starts = torch.tensor([0, 1, 200, 511], dtype=torch.int32,
                          device=cuda_device)
    q = tdec._prep_query(torch.randn((b, s, h, hd), generator=gen,
                                     device=cuda_device), hd)[0]
    w = torch.randint(-127, 128, (14_336, 4096), generator=gen,
                      device=cuda_device, dtype=torch.int8)
    scale = torch.rand((1, 4096), generator=gen, device=cuda_device) / 64
    x = torch.randn((8, 14_336), generator=gen,
                    device=cuda_device).to(torch.bfloat16)

    def run():
        return (*tdec.flash_verify_attention_paged(q, k_pool, v_pool, 0,
                                                   table, starts),
                int8_matmul(x, w, scale))
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    starts.copy_(torch.tensor([5, 0, 511, 300], dtype=torch.int32))
    graph.replay()
    moved = run()
    torch.cuda.synchronize()
    for got, want in zip(captured, moved):
        assert torch.equal(got, want)
    starts.copy_(torch.tensor([0, 1, 200, 511], dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, eager):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page_tokens", [64, 16])
def test_decode_forms_split_body_match_plain(cuda_device, int8, page_tokens):
    """The decode forms on the split body at one query token: #2's and
    #3's partials against the plain split partials (acc on the live
    splits), the decode combine
    against the plain combine on them, #1, #2 and #3 against their plain
    versions (f32 queries within F32, bf16 queries on the normalised
    output within BF16), #3 bitwise equal to #1 and #2 on the gathered
    view, lengths 0, 1, mid-page, T - 1 and T, the length-0 row neutral."""
    gen = torch.Generator(device=cuda_device).manual_seed(31 + page_tokens)
    b, pps, kv, hd, h = 5, 1024 // page_tokens, 2, 128, 8
    pages = b * pps + 1
    t = pps * page_tokens
    shape = (1, pages, page_tokens, kv * hd)
    if int8:
        (k_pool, ks_pool), (v_pool, vs_pool) = (
            _int8_pool(shape, gen, cuda_device) for _ in range(2))
    else:
        k_pool, v_pool = (torch.randn(shape, generator=gen,
                                      device=cuda_device).to(torch.bfloat16)
                          for _ in range(2))
        ks_pool = vs_pool = None
    table = (torch.randperm(pages - 1, generator=gen, device=cuda_device)
             + 1).reshape(b, pps).to(torch.int32)
    lengths = torch.tensor([0, 1, t // 2 + 3, t - 1, t], dtype=torch.int32,
                           device=cuda_device)
    q = torch.randn((b, h, hd), generator=gen, device=cuda_device)

    def stacked(pool):
        return None if pool is None else \
            pool[:, table.long()].reshape(1, b, t, -1).contiguous()
    views = [stacked(pool) for pool in (k_pool, v_pool, ks_pool, vs_pool)]
    flat = [None if view is None else view[0] for view in views]
    for q_in in (tdec._prep_query(q, hd)[0],
                 tdec._prep_query(q.to(torch.bfloat16), 64)[0]):
        parts = tdec.flash_decode_partials_paged(
            q_in, k_pool, v_pool, 0, table, lengths, ks_pool, vs_pool)
        parts_stacked = tdec.flash_decode_partials_stacked(
            q_in, views[0], views[1], 0, lengths, *views[2:])
        parts_plain = tdec.flash_decode_partials_reference(
            q_in, *flat[:2], lengths, *flat[2:])
        merged = tdec.decode_combine(*parts)
        merged_plain = tdec.decode_combine_reference(*parts)
        forms = [tdec.flash_decode_attention_paged(
                     q_in, k_pool, v_pool, 0, table, lengths, ks_pool,
                     vs_pool),
                 tdec.flash_decode_attention_stacked(
                     q_in, views[0], views[1], 0, lengths, *views[2:]),
                 tdec.flash_decode_attention(q_in, *flat[:2], lengths,
                                             *flat[2:])]
        plain = tdec.flash_decode_attention_reference(q_in, *flat[:2],
                                                      lengths, *flat[2:])
        torch.cuda.synchronize()
        # A split past a row's length writes m and l only (the combine
        # skips it): acc partials are compared on the live splits.
        live = parts[1] > -1e29
        assert torch.equal(parts[0][live], parts_stacked[0][live])
        for got, same in zip(parts[1:], parts_stacked[1:]):
            assert torch.equal(got, same)
        for got, want in zip(merged, merged_plain):
            torch.testing.assert_close(got, want, **F32)
        for form in forms:
            for got, same in zip(form, forms[0]):
                assert torch.equal(got, same)
        for got, same in zip(merged, forms[0]):
            assert torch.equal(got, same)
        if q_in.dtype == torch.float32:
            torch.testing.assert_close(parts[0][live], parts_plain[0][live],
                                       **F32)
            for got, want in zip(parts[1:], parts_plain[1:]):
                torch.testing.assert_close(got, want, **F32)
            for got, want in zip(forms[0], plain):
                torch.testing.assert_close(got, want, **F32)
        else:
            assert _normalised_error(forms[0], plain) <= BF16["atol"]
        acc, m, l = forms[0]
        assert acc[0].abs().max() == 0 and l[0].abs().max() == 0
        assert (m[0] == -1e30).all()


def _tie_heavy_rows(gen, device, b, vocab):
    """Logit rows that stress the tie rule: tied maxima, a 100-way tie, a
    mostly -inf row, an all -inf row, ties everywhere, and -0 beside +0."""
    x = torch.randn((b, vocab), generator=gen, device=device)
    x[0, [7, vocab // 2, vocab - 1, 3]] = 9.0
    x[1, 1000:1100] = 5.0
    x[2] = float("-inf")
    x[2, [5, vocab - 7]] = 1.0
    x[3] = float("-inf")
    x[4, ::2] = 0.25
    x[5] = 0.0
    x[5, 1::3] = -0.0
    x[5, 40] = 1.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("b,vocab", [(8, 128_256), (6, 5001), (1, 128_256)])
def test_topk_threshold_select_exact_on_tie_heavy_rows(cuda_device, b,
                                                       vocab):
    """Top-k by threshold select: values and indices exactly the stable
    sort's, and the kernel's own algorithm's plain version, at k 1, 50
    and 128, with no duplicate index, on tie-heavy rows, V both a
    multiple of the chunk and not, and a strided view of wider rows."""
    from aiko_services_tpu_torch.ops.topk import topk_threshold_reference
    gen = torch.Generator(device=cuda_device).manual_seed(vocab + b)
    x = _tie_heavy_rows(gen, cuda_device, max(b, 6), vocab)[:b]
    wide = torch.full((b, vocab + 3), 7.0, device=cuda_device)
    wide[:, 1:vocab + 1] = x
    for rows in (x, wide[:, 1:vocab + 1]):
        for k in (1, 50, 128):
            got_v, got_i = topk(rows, k)
            ref_v, ref_i = topk_reference(rows, k)
            alg_v, alg_i = topk_threshold_reference(rows, k)
            torch.cuda.synchronize()
            assert torch.equal(got_i, ref_i) and torch.equal(got_v, ref_v)
            assert torch.equal(alg_i, ref_i)
            for row in got_i.tolist():
                assert len(set(row)) == k


@pytest.mark.cuda
def test_decode_and_topk_replay_in_a_graph(cuda_device):
    """The decode forms (#2 stacked, #3 paged, each with its combine) and
    top-k captured in one CUDA graph: a replay equals the eager calls
    bit for bit, also after the lengths change (the split and the chunk
    plan depend on shapes only)."""
    gen = torch.Generator(device=cuda_device).manual_seed(41)
    b, pps, pt, kv, hd, h = 4, 8, 64, 2, 128, 8
    pages = b * pps + 1
    k_pool, v_pool = (torch.randn((1, pages, pt, kv * hd), generator=gen,
                                  device=cuda_device).to(torch.bfloat16)
                      for _ in range(2))
    table = (torch.arange(b * pps, device=cuda_device) + 1).reshape(
        b, pps).to(torch.int32)
    k_flat = k_pool[:, table.long()].reshape(1, b, pps * pt, -1).contiguous()
    v_flat = v_pool[:, table.long()].reshape(1, b, pps * pt, -1).contiguous()
    lengths = torch.tensor([0, 1, 200, 511], dtype=torch.int32,
                           device=cuda_device)
    q = tdec._prep_query(torch.randn((b, h, hd), generator=gen,
                                     device=cuda_device), hd)[0]
    logits = _tie_heavy_rows(gen, cuda_device, 8, 128_256)

    def run():
        return (*tdec.flash_decode_attention_paged(q, k_pool, v_pool, 0,
                                                   table, lengths),
                *tdec.flash_decode_attention_stacked(q, k_flat, v_flat, 0,
                                                     lengths),
                *topk(logits, 50))
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    lengths.copy_(torch.tensor([5, 0, 511, 300], dtype=torch.int32))
    logits[1].neg_()
    graph.replay()
    moved = run()
    torch.cuda.synchronize()
    for got, want in zip(captured, moved):
        assert torch.equal(got, want)
    lengths.copy_(torch.tensor([0, 1, 200, 511], dtype=torch.int32))
    logits[1].neg_()
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, eager):
        assert torch.equal(got, want)
