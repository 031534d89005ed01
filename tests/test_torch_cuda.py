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
from aiko_services_tpu_torch.pipeline import PipelineElement, StreamEvent

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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("q_offset", [0, 1536])
def test_flash_attention_device_row_and_offset_equal_host_launch(
        cuda_device, q_offset, dtype):
    """#4 given ``at`` (k/v row, offset) on the card over a whole cache
    layer equals the host-int launch on that row's slice, bit for bit,
    in both bodies."""
    gen = torch.Generator(device=cuda_device).manual_seed(q_offset + 3)
    rows, t, s, kv, groups, d = 3, 2048, 512, 2, 4, 128
    k = (torch.randn((rows, t, kv, d), generator=gen, device=cuda_device)
         * 0.5).to(dtype)
    v = torch.randn((rows, t, kv, d), generator=gen,
                    device=cuda_device).to(dtype)
    q = torch.randn((1, s, kv * groups, d), generator=gen,
                    device=cuda_device).to(dtype)
    want = tatt.flash_attention(q, k[2:3], v[2:3], q_offset=q_offset)
    at = torch.tensor([2, q_offset], dtype=torch.int32, device=cuda_device)
    got = tatt.flash_attention(q, k, v, at=at)
    assert torch.equal(got, want)


def _admission_config(dtype="bfloat16"):
    import dataclasses

    from aiko_services_tpu_torch.models import llama
    return dataclasses.replace(
        llama.LlamaConfig.tiny(vocab_size=512, max_seq=256), dim=256,
        hidden_dim=512, attention="flash", decode_attention="flash",
        dtype=dtype)


@pytest.mark.cuda
def test_captured_admission_equals_eager_for_any_slot_and_offset(
        cuda_device):
    """One captured admission chunk replayed at several slots and starts
    equals the eager chunk at the same host ints: its logits and the
    cache, bit for bit; it captures once, each replay adds #4's captured
    launches to its counter, a moved cache raises and ``reset``
    recaptures."""
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.loop_graph import AdmissionRunner
    config = _admission_config()
    params = llama.init_params(0, config, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    eager_cache = llama.init_cache(config, 4, device=cuda_device)
    for side in ("k", "v"):
        eager_cache[side].copy_(torch.randn(
            eager_cache[side].shape, generator=gen, device=cuda_device))
    graph_cache = {side: eager_cache[side].clone() for side in ("k", "v")}
    runner = AdmissionRunner(params, config, chunk=64, device=cuda_device)
    tokens = torch.randint(1, 512, (4, 1, 64),
                           generator=torch.Generator().manual_seed(5))
    for index, (slot, start) in enumerate(((1, 0), (3, 64), (1, 64),
                                           (0, 192))):
        want, _ = llama.prefill_into_slot(
            params, config, tokens[index].to(cuda_device), eager_cache,
            slot, start)
        before = tatt.flash_attention.launches
        got, _ = llama.prefill_into_slot(params, config, tokens[index],
                                         graph_cache, slot, start,
                                         runner=runner)
        torch.cuda.synchronize()
        grown = tatt.flash_attention.launches - before
        # the first call's warm-up runs eagerly before its replay
        assert grown == config.n_layers * (2 if index == 0 else 1)
        assert torch.equal(got, want), (slot, start)
        for side in ("k", "v"):
            assert torch.equal(graph_cache[side], eager_cache[side])
    assert runner.captures == 1 and runner.replays == 4
    moved = {side: graph_cache[side].clone() for side in ("k", "v")}
    with pytest.raises(RuntimeError, match="AdmissionRunner: the cache"):
        runner.run(moved, tokens[0], 0, 0)
    runner.reset()
    runner.run(moved, tokens[0], 2, 128)
    assert runner.captures == 2 and runner.replays == 5


@pytest.mark.cuda
def test_batcher_admits_through_one_capture_and_recover_recaptures(
        cuda_device, monkeypatch):
    """A batcher on the card writes every flash admission chunk by a
    replay of one captured graph, over several slots and offsets, and
    emits the streams an eager batcher emits; ``recover()`` drops the
    graph and the next admission captures anew."""
    from aiko_services_tpu_torch.models import batching, llama
    config = _admission_config()
    params = llama.init_params(0, config, device=cuda_device)
    rng = torch.Generator().manual_seed(7)
    lengths = (150, 70, 30, 200, 90)
    prompts = [torch.randint(1, 512, (n,), generator=rng).tolist()
               for n in lengths]

    def serve(batcher):
        streams = {}
        for index, prompt in enumerate(prompts):
            streams[index] = []
            batcher.submit(batching.Request(
                str(index), list(prompt), max_new_tokens=12,
                emit=lambda rid, token, done, i=index:
                    streams[i].append(int(token))))
        batcher.run_until_drained(max_steps=2000)
        return streams

    def build():
        return batching.ContinuousBatcher(
            params, config, max_slots=3, max_seq=256, prefill_chunk=64,
            decode_block_tokens=16, device=cuda_device)
    captured = build()
    got = serve(captured)
    chunks = sum(-(-n // 64) for n in lengths)
    runner = captured._admission
    assert runner.captures == 1 and runner.replays == chunks
    assert captured.admission_replays == chunks
    assert captured.admission_eager == 0
    monkeypatch.setattr(batching, "captures_admission",
                        lambda *args: False)
    eager = build()
    assert eager._admission is None
    assert serve(eager) == got
    assert eager.admission_eager == chunks
    captured.recover()
    assert runner._graph is None
    serve(captured)
    assert runner.captures == 2


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


@pytest.mark.cuda
def test_direct_launch_draws_as_torch_replay(cuda_device, monkeypatch):
    """Blocks that sample (temperature 1) launched as the runner does
    after its first replay -- the exec through the runtime with the GIL
    held, after the prologue graph -- equal the same blocks replayed by
    torch each time: the emitted tokens, every carry, the cache and the
    generator's offset, over four chained blocks."""
    import dataclasses

    from aiko_services_tpu_torch.models import llama, loop_graph
    from aiko_services_tpu_torch.models.loop_graph import LoopRunner
    assert loop_graph.runtime_launch() is not None
    config = dataclasses.replace(
        llama.LlamaConfig.tiny(vocab_size=512, max_seq=128), dim=256,
        hidden_dim=512, decode_attention="flash")
    params = llama.init_params(0, config, device=cuda_device)
    b, ring = 4, 8
    inputs = {
        "tokens": torch.tensor([5, 9, 2, 7], dtype=torch.int32),
        "lengths": torch.tensor([10, 30, 60, 0], dtype=torch.int32),
        "active": torch.tensor([True, True, True, False]),
        "budget": torch.tensor([40, 40, 40, 0], dtype=torch.int32),
        "temperatures": torch.tensor([1.0, 1.0, 0.7, 1.0]),
        "eos": torch.full((b, 1), -1, dtype=torch.int32),
        "history": torch.full((b, 1), -1, dtype=torch.int32)}

    def serve(direct: bool):
        if not direct:
            monkeypatch.setattr(loop_graph, "runtime_launch", lambda: None)
        cache = llama.init_cache(config, b, device=cuda_device)
        generator = torch.Generator(device=cuda_device).manual_seed(3)
        runner = LoopRunner(params, config, batch=b, ring=ring,
                            speculative="off", spec_tokens=3,
                            spec_window=8, draft=None, top_k=0,
                            generator=generator, history_width=1,
                            device=cuda_device)
        for name, value in inputs.items():
            runner.upload(name, value.numpy())
        blocks = []
        for _ in range(4):
            out = runner.run(cache)
            blocks.append({name: value.clone() for name, value in
                           out.items()})
        torch.cuda.synchronize()
        monkeypatch.undo()
        assert runner._direct is direct and runner.replays == 4
        assert (runner._prologue is not None) is direct
        return blocks, cache, generator.get_offset()
    torch_blocks, torch_cache, torch_offset = serve(direct=False)
    blocks, cache, offset = serve(direct=True)
    assert offset == torch_offset > 0
    emitted = 0
    for got, want in zip(blocks, torch_blocks):
        for name, value in want.items():
            assert torch.equal(got[name], value), name
        emitted += int(want["counts"].sum())
    assert emitted > 3 * ring
    for side in ("k", "v"):
        assert torch.equal(cache[side], torch_cache[side])


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


# -- the pipeline engine's guard, window and capture on the card --------------

class Upload(PipelineElement):
    """Pipeline element: host value -> tensor on the card."""
    device_resident = True

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"x": torch.as_tensor(x).cuda()}


class ItemCall(PipelineElement):
    """A device element that forces a per-frame host sync."""
    device_resident = True

    def process_frame(self, stream, x=None, **inputs):
        return StreamEvent.OKAY, {"total": (x * 2).sum().item()}


@pytest.mark.cuda
def test_guard_disallow_fails_item_through_ledger(cuda_device, tmp_path):
    """Under ``transfer_guard: disallow`` a port element that calls
    ``.item()`` on the card fails its frame and counts as implicit; the
    ledger's own fetch inside the guard does not trip it."""
    import json
    import queue

    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.pipeline.overlap import TransferLedger
    from aiko_services_tpu_torch.runtime import init_process, reset_process
    from aiko_services_tpu_torch.transport import reset_broker
    ledger = TransferLedger("disallow")
    x = torch.arange(4, device=cuda_device, dtype=torch.float32)
    with ledger.guard():
        with pytest.raises(RuntimeError) as raised:
            x.sum().item()
        fetched = ledger.fetch({"x": x, "n": 1})
    assert ledger.is_guard_error(raised.value)
    assert fetched["x"].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert ledger.stats["explicit"] == 1
    assert torch.cuda.get_sync_debug_mode() == 0    # the guard is lifted

    module = __name__
    body = {"version": 0, "name": "guard", "runtime": "torch",
            "graph": ["(up item)"],
            "parameters": {"transfer_guard": "disallow"},
            "elements": [
                {"name": name, "input": [{"name": "x"}],
                 "output": [{"name": out}],
                 "deploy": {"local": {"module": module,
                                      "class_name": cls}}}
                for name, cls, out in (("up", "Upload", "x"),
                                       ("item", "ItemCall", "total"))]}
    path = tmp_path / "guard.json"
    path.write_text(json.dumps(body))
    reset_broker()
    runtime = init_process(transport="loopback")
    runtime.initialize()
    try:
        responses = queue.Queue()
        pipeline = create_pipeline(str(path), runtime=runtime)
        stream = pipeline.create_stream_local("s", queue_response=responses)
        pipeline.create_frame_local(stream, {"x": [1.0, 2.0]})
        runtime.run(until=lambda: not responses.empty(), timeout=30.0)
        *_, okay, diagnostic = responses.get()
        assert not okay and "synchronizing" in diagnostic
        assert pipeline.transfer_stats()["implicit"] == 1
        pipeline.stop()
    finally:
        runtime.engine.terminate()
        reset_process()
        reset_broker()


@pytest.mark.cuda
def test_device_window_paces_on_card_events(cuda_device):
    """``DeviceWindow`` notes a frame's card work with an event and
    paces by waiting on the oldest events only."""
    from aiko_services_tpu_torch.pipeline.overlap import DeviceWindow
    window = DeviceWindow()
    a = torch.randn((2048, 2048), device=cuda_device)
    outputs = []
    for frame_id in range(4):
        for _ in range(8):
            a = torch.tanh(a @ a * 1e-3)
        outputs.append(a.clone())
        window.note(frame_id, {"x": outputs[-1], "label": "frame"})
    events = [entry[2][0] for entry in window._inflight]
    assert window.noted == 4 and len(events) == 4
    waited = window.pace(2)
    assert window.synced == 3 and window.outstanding == 1 and waited >= 0
    assert all(event.query() for event in events[:3])
    window.drain()
    assert window.outstanding == 0 and events[3].query()


@pytest.mark.cuda
def test_loop_capture_on_worker_thread_while_loop_thread_uses_card(
        cuda_device):
    """The LLM element's worker captures the decode loop's graph under
    the ledger's process-wide guard while the event-loop thread keeps
    using the card (fresh allocations, launches and events on its own
    stream).  In ``thread_local`` capture mode neither fails, the capture
    lifts the guard for its own synchronisation, and the replayed block
    equals the eager one."""
    import dataclasses
    import threading

    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.models.loop_graph import LoopRunner
    from aiko_services_tpu_torch.pipeline.overlap import TransferLedger
    config = dataclasses.replace(
        llama.LlamaConfig.tiny(vocab_size=512, max_seq=128), dim=256,
        hidden_dim=512, decode_attention="flash")
    params = llama.init_params(0, config, device=cuda_device)
    b, ring = 4, 12
    inputs = {
        "tokens": torch.tensor([5, 9, 2, 7], dtype=torch.int32),
        "lengths": torch.tensor([10, 50, 100, 0], dtype=torch.int32),
        "active": torch.tensor([True, True, True, False]),
        "budget": torch.tensor([12, 5, 12, 0], dtype=torch.int32),
        "temperatures": torch.zeros(b),
        "eos": torch.full((b, 1), -1, dtype=torch.int32),
        "history": torch.full((b, 1), -1, dtype=torch.int32)}
    options = dict(ring=ring, speculative="off", spec_tokens=3,
                   spec_window=8, top_k=0)
    eager_cache = llama.init_cache(config, b, device=cuda_device)
    graph_cache = {name: tensor.clone()
                   for name, tensor in eager_cache.items()}
    dev = {name: value.to(cuda_device) for name, value in inputs.items()}
    eager = llama.decode_loop(
        params, config, dev["tokens"], eager_cache, dev["lengths"],
        dev["active"], dev["budget"], dev["temperatures"], dev["eos"],
        dev["history"], torch.Generator(device=cuda_device).manual_seed(0),
        **options)
    torch.cuda.synchronize()
    runner = LoopRunner(params, config, batch=b, draft=None,
                        generator=torch.Generator(device=cuda_device)
                        .manual_seed(0), history_width=1,
                        device=cuda_device, **options)
    for name, value in inputs.items():
        runner.upload(name, value.numpy())
    ledger = TransferLedger("disallow")
    result, failure = {}, []
    done = threading.Event()

    def worker():
        try:
            with ledger.guard():
                result.update(runner.run(graph_cache))
        except Exception as error:      # reported by the main thread
            failure.append(error)
        finally:
            done.set()
    thread = threading.Thread(target=worker)
    side = torch.cuda.Stream(cuda_device)
    busy = 0
    thread.start()
    while not done.is_set() or busy < 20:
        with torch.cuda.stream(side):
            fresh = torch.empty((1 << 20) + busy * 4096,
                                device=cuda_device)
            fresh.fill_(1.0).mul_(2.0)
            event = torch.cuda.Event()
            event.record(side)
            event.query()
        busy += 1
    thread.join()
    torch.cuda.synchronize()
    assert not failure, failure
    assert runner.captures == 1 and busy >= 20
    names = ("emitted", "counts", "tokens", "lengths", "active", "budget",
             "history", None, "accepted", "drafted", "steps")
    want = {name: value for name, value in zip(names, eager) if name}
    for row in range(b):
        count = int(want["counts"][row])
        assert torch.equal(result["emitted"][row, :count],
                           want["emitted"][row, :count])
    for name in ("counts", "tokens", "lengths", "active", "budget"):
        assert torch.equal(result[name], want[name]), name


# -- the compiled cache and the detector on the card --------------------------

@pytest.mark.cuda
def test_jit_cache_replay_equals_eager(cuda_device):
    """``JitCache`` on the card: a miss captures the function as a CUDA
    graph (here the detector's detect and a top-k launch), each hit
    replays it on copies of the new inputs and returns outputs of its
    own (a later replay leaves an earlier result as it was), the replay
    equals the eager call, and the launch counter counts the top-k
    launches that ran: the warm-up's, then one a replay (the capture's
    own is taken back)."""
    import dataclasses

    from aiko_services_tpu_torch.models import detector
    from aiko_services_tpu_torch.pipeline.tensor import JitCache
    config = dataclasses.replace(detector.DetectorConfig.tiny(),
                                 dtype="float32")
    params = detector.init_params(0, config, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)

    def fn(params, images):
        out = detector.detect(params, config, images)
        out["top"] = topk(images.reshape(images.shape[0], -1), 5)[1]
        return out
    cache = JitCache()
    cached = cache(fn)
    first_images = torch.rand((2, 64, 80, 3), generator=gen,
                              device=cuda_device)
    second_images = torch.rand((2, 64, 80, 3), generator=gen,
                               device=cuda_device)
    launches = topk.launches
    first = cached(params, first_images)
    second = cached(params, second_images)
    torch.cuda.synchronize()
    assert (cache.misses, cache.hits, cache.entries) == (1, 1, 1)
    assert topk.launches == launches + 3
    for images, got in ((first_images, first), (second_images, second)):
        want = fn(params, images)
        torch.cuda.synchronize()
        for name in ("valid", "classes", "top"):
            assert torch.equal(got[name], want[name]), name
        for name in ("boxes", "scores"):
            torch.testing.assert_close(got[name], want[name], **F32)
    assert cache.capture_s > 0


@pytest.mark.cuda
def test_detector_captures_on_worker_thread_while_another_thread_uses_card(
        cuda_device, tmp_path):
    """The Detector's micro-batch worker captures detect on its own
    stream while another thread -- standing in for the LLM worker --
    keeps using the card under the process-wide ``disallow`` guard
    (fresh allocations, launches and events on its own stream).  Neither
    fails: the capture and the worker's one wait lift the guard, and
    the upload goes through pinned memory.  Each frame's detections
    equal the eager detect of the same padded batch."""
    import json
    import queue
    import threading

    import numpy as np

    from aiko_services_tpu_torch.device import sync_guard
    from aiko_services_tpu_torch.models import detector
    from aiko_services_tpu_torch.pipeline import create_pipeline
    from aiko_services_tpu_torch.runtime import init_process, reset_process
    from aiko_services_tpu_torch.transport import reset_broker
    body = {"version": 0, "name": "det", "runtime": "torch",
            "graph": ["(DET)"],
            "elements": [{
                "name": "DET", "input": [{"name": "image"}],
                "output": [{"name": "detections"}],
                "parameters": {"width": 8, "max_batch": 8},
                "placement": {"mesh": {"dp": 1}},
                "deploy": {"local": {
                    "module": "aiko_services_tpu_torch.elements.detect",
                    "class_name": "Detector"}}}]}
    path = tmp_path / "det.json"
    path.write_text(json.dumps(body))
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
              for _ in range(3)]
    stop, failure = threading.Event(), []

    def busy():
        side = torch.cuda.Stream(cuda_device)
        try:
            with sync_guard("error"):
                count = 0
                while not stop.is_set() or count < 20:
                    with torch.cuda.stream(side):
                        fresh = torch.empty((1 << 20) + count * 4096,
                                            device=cuda_device)
                        fresh.fill_(1.0).mul_(2.0)
                        event = torch.cuda.Event()
                        event.record(side)
                        event.query()
                    count += 1
        except Exception as error:      # reported by the main thread
            failure.append(error)
    thread = threading.Thread(target=busy)
    reset_broker()
    runtime = init_process(transport="loopback")
    runtime.initialize()
    try:
        pipeline = create_pipeline(str(path), runtime=runtime)
        thread.start()
        responses = queue.Queue()
        stream = pipeline.create_stream_local("s", queue_response=responses)
        for image in images:
            pipeline.create_frame_local(stream, {"image": image})
        runtime.run(until=lambda: responses.qsize() >= len(images),
                    timeout=120.0)
        stop.set()
        thread.join()
        assert not failure, failure
        got = {}
        while not responses.empty():
            _, frame_id, swag, _, okay, diagnostic = responses.get()
            assert okay, diagnostic
            got[frame_id] = swag["detections"]
        assert sorted(got) == [0, 1, 2]
        det = pipeline.graph.get_node("DET").element
        assert det.jit_cache.misses == 1 and det.jit_cache.capture_s > 0
        padded = images + images[:1]
        batch = torch.from_numpy(np.stack(padded)).to(cuda_device)
        want = detector.detect(det._params, det._config,
                               batch.float() / 255.0)
        fetched = {name: value.cpu().numpy() for name, value in want.items()}
        for row in range(len(images)):
            expected = det._slate_outputs(fetched, row)["detections"]
            assert [d["class"] for d in got[row]] \
                == [d["class"] for d in expected]
            for a, b in zip(got[row], expected):
                assert abs(a["score"] - b["score"]) <= 1e-3
                np.testing.assert_allclose(a["box"], b["box"], atol=1e-3)
        pipeline.stop()
    finally:
        stop.set()
        if thread.is_alive():
            thread.join()
        runtime.engine.terminate()
        reset_process()
        reset_broker()
