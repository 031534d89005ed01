"""The operation and byte counts against hand counts at Mistral-7B-v0.3
widths (and the detector's at YOLO-n scale)."""

import json
from pathlib import Path

from torch_bench.models import detector, llama

ROOT = Path(__file__).resolve().parents[2]
SIZES = llama.Sizes.of(json.loads(
    (ROOT / "torch_bench/configs/mistral-7b-v0.3.json").read_text()))

# One layer's weights: wq and wo 4096 x 4096, wk and wv 4096 x 1024,
# w_gate, w_up and w_down 4096 x 14336.
LAYER = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336


def test_sizes():
    assert (SIZES.dim, SIZES.layers, SIZES.heads, SIZES.kv_heads,
            SIZES.ffn, SIZES.vocab, SIZES.head_dim) == \
        (4096, 32, 32, 8, 14336, 32768, 128)
    assert LAYER == 218_103_808
    # 7.25 B: the layers, the embedding, the head and the norms.
    assert llama.parameters(SIZES) == \
        32 * LAYER + 2 * 32768 * 4096 + 32 * 2 * 4096 + 4096 \
        == 7_248_023_552


def test_token_flops():
    assert llama.matmul_flops_per_token(SIZES) == \
        2 * (32 * LAYER + 4096 * 32768) == 14_227_079_168
    # attention at 1,000 positions: 4 x 32 layers x 32 heads x 128
    assert llama.attention_flops(SIZES, 1000) == 524_288_000
    assert llama.token_flops(SIZES, 1000) == 14_227_079_168 + 524_288_000


def test_decode_attention_bytes():
    # 131,072 bytes of bf16 keys and values a position over 32 layers,
    # plus each layer's bf16 query and output (32 x 128 each)
    n_bytes, flops = llama.decode_attention_work(SIZES, 1000)
    assert n_bytes == 1000 * 131_072 + 32 * 2 * 32 * 128 * 2
    assert flops == 4 * 32 * 32 * 128 * 1000


def test_prefill_attention_at_an_offset():
    # a 512-token chunk after 1,536 positions: each query attends its
    # offset and the chunk up to itself
    n_bytes, flops = llama.prefill_attention_work(SIZES, 1536, 512)
    positions = 512 * 1536 + 512 * 513 // 2
    assert flops == 4 * 32 * 32 * 128 * positions
    # one layer's bound: 15.0 GFLOP at 989 TFLOP/s, about 15.2 us
    assert abs(flops / 32 / 989e12 * 1e6 - 15.20) < 0.01
    assert n_bytes == 32 * (2 * 512 * 4096 * 2 + 2048 * 1024 * 2 * 2)
    assert llama.chunk_flops(SIZES, 1536, 512) == \
        512 * 14_227_079_168 + flops


def test_detector_convolutions():
    config = {"width": 32, "depth": 1, "num_classes": 80}
    # the stem alone: 32 x 3 x 3 x 3 multiply-adds at 320 x 320
    stem = 2 * 32 * 3 * 9 * 320 * 320
    assert stem == 176_947_200
    # multiply-adds by hand: (cout, cin, kernel, output side)
    convs = [(32, 3, 3, 320), (64, 32, 3, 160), (64, 64, 3, 160),
             (64, 64, 3, 160), (64, 64, 3, 80), (64, 64, 3, 80),
             (64, 64, 3, 80), (128, 64, 3, 40), (128, 128, 3, 40),
             (128, 128, 3, 40), (256, 128, 3, 20), (256, 256, 3, 20),
             (256, 256, 3, 20), (128, 384, 1, 40), (64, 192, 1, 80),
             (84, 64, 1, 80), (84, 128, 1, 40), (84, 256, 1, 20)]
    hand = 2 * sum(co * ci * k * k * n * n for co, ci, k, n in convs)
    assert detector.conv_flops(config, 1, 640) == hand
    assert detector.conv_flops(config, 8, 640) == 8 * hand
