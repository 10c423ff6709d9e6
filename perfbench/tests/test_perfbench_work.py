"""The FLOP and byte reckoners against hand counts at small shapes, and
the bounds PERF.md's kernel table gives."""

import pytest
import torch

from perfbench import work


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("sq,sk,window,pairs", [
    (4, 4, None, 10),          # 1 + 2 + 3 + 4
    (2, 4, None, 7),           # queries see 3 and 4 keys
    (4, 4, 2, 7),              # 1 + 2 + 2 + 2
    (1, 5, None, 5),
    (3, 1, None, 1),           # only the last query sees the key
])
def test_causal_pairs(sq, sk, window, pairs):
    assert work.causal_pairs(sq, sk, window) == pairs


def test_flash_attention_hand_count():
    # B 1, Sq = Sk 3, 2 heads of D 4, Dv 2: 6 causal pairs a head
    ops, nbytes, dt = work.flash_attention(meta(1, 3, 2, 4), meta(1, 3, 2, 4),
                                           meta(1, 3, 2, 2))
    assert ops == 2 * 2 * 6 * (4 + 2)
    assert nbytes == 2 * (24 + 24 + 12 + 12)
    assert dt == "bfloat16"
    ops, _, _ = work.flash_attention(meta(1, 3, 2, 4), meta(1, 3, 2, 4),
                                     meta(1, 3, 2, 2), causal=False)
    assert ops == 2 * 2 * 9 * 6


def test_bounds_of_the_kernel_table():
    """PERF.md's bounds: K5 at (4, 512, 32, 80) bf16 41,943,040 bytes;
    K7 at x (4, 512, 80, 64), n 64, 48,366,208; K3 at 117,964,800 float32
    591,667,200."""
    q = meta(4, 512, 32, 80)
    assert work.flash_attention(q, q, q)[1] == 41_943_040
    f32 = torch.float32
    ssd = work.ssd_scan(meta(4, 512, 80, 64), meta(4, 512, 80, dtype=f32),
                        meta(80, dtype=f32), meta(4, 512, 1, 64),
                        meta(4, 512, 1, 64), meta(80, dtype=f32))
    assert ssd[1] == 48_366_208
    assert work.quant_pack(meta(117_964_800, dtype=f32))[1] == 591_667_200
    assert work.bound_s(ssd) == pytest.approx(48_366_208 / 3.35e12)


def test_ssd_scan_hand_count():
    # b 1, s 2, h 1, p 2, n 3: 4 p n + 2 p = 28 a step
    f32 = torch.float32
    ops, nbytes, _ = work.ssd_scan(
        meta(1, 2, 1, 2, dtype=f32), meta(1, 2, 1, dtype=f32),
        meta(1, dtype=f32), meta(1, 2, 1, 3, dtype=f32),
        meta(1, 2, 1, 3, dtype=f32), meta(1, dtype=f32))
    assert ops == 2 * 28
    assert nbytes == 4 * ((4 + 2 + 1 + 6 + 6 + 1) + 4 + 6)


def test_model_flops_hand_count():
    port = {"d_model": 4, "vocab_size": 10, "ssm_state": 2,
            "mamba_headdim": 2, "mamba_expand": 2, "conv_width": 2,
            "stages": [{"unit": ["mamba"], "repeats": 2}]}
    B, S = 1, 2
    # mamba: di 8, h 4: projections 2*4*(16 + 4 + 4) + 2*8*4 = 256,
    # conv 2*2*(8 + 4) = 48, scan 4*(4*2*2 + 2*2) = 80: 384 a token
    mamba = 2 * 384
    head = 2 * B * S * 4 * 10
    assert work.forward_flops(port, B, S) == 2 * mamba + head
    assert work.train_flops(port, B, S) == 3 * work.forward_flops(port, B, S)
    moe = {"d_model": 4, "vocab_size": 10, "n_heads": 1, "kv_lora_rank": 2,
           "qk_nope_dim": 2, "qk_rope_dim": 2, "v_head_dim": 2,
           "n_experts": 4, "top_k": 2, "n_shared_experts": 1,
           "expert_d_ff": 3,
           "stages": [{"unit": ["mla_moe"], "repeats": 1}]}
    # MLA: 2*4*4 + 2*4*4 + 2*2*4 + 2*2*4 = 96; router 2*4*4 = 32;
    # experts (2 routed + 1 shared) 3 * 6*4*3 = 216: 344 a token;
    # attention 2 * 1 head * 1 pair * (4 + 2) = 12
    assert work.forward_flops(moe, 1, 1) == 344 + 12 + 2 * 4 * 10
