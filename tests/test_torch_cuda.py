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
from aiko_services_tpu_torch.ops.int8_matmul import (int8_matmul,
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
