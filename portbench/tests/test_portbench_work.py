"""The frozen work and bound functions reproduce the port's tabulated
bounds (PERF.md's kernel table), and the ragged count agrees with a
brute-force count over positions."""
import numpy as np
import pytest

from portbench import work as WK


@pytest.mark.parametrize("case,bound_ms", [
    ("dequant_matmul_slots", 0.0400),   # slots, B = 2, 2-bit, Mixtral's layer
    ("dequant_matmul", 0.0200),         # 2-D, one row
])
def test_dequant_bounds(case, bound_ms):
    assert round(WK.bound(*WK.dequant_layer_work(case, 2))[0], 4) == bound_ms


def test_grouped_bound_at_8192_rows():
    # the grouped kernel over 8192 routed rows, 1024 per Mixtral expert
    ms, by = WK.bound(*WK.grouped_work([1024] * 8, 2))
    assert round(ms, 2) == 2.92 and by == "operations"


def test_flash_chunk_bound():
    # the 64-token prefill chunk at Mixtral's heads, window 4096, bf16
    ms, by = WK.bound(*WK.flash_work(64, 64, 0, 4096, 32, 8, 128))
    assert round(ms, 5) == 0.00039 and by == "bytes"


def test_causal_f32_flash_bound():
    # group (a)'s causal flash, 8 / 2 heads x 1024 x 64, float32
    ms, by = WK.bound(*WK.flash_work(1024, 1024, 0, None, 8, 2, 64, elem=4),
                      WK.F32_FLOP_PER_S)
    assert round(ms, 4) == 0.0160 and by == "operations"


@pytest.mark.parametrize("window", (None, 40))
@pytest.mark.parametrize("C", (1, 5))
def test_ragged_work_counts_pages_and_pairs(window, C):
    ps, heads = 16, (4, 2, 8)
    pos = np.array([0, 7, 37, 100])
    nbytes, flops = WK.ragged_work(pos, C, heads, window, ps)
    pages = pairs = 0
    for p in pos:
        seen = set()
        for q in range(p, p + C):
            keys = [k for k in range(q + 1) if window is None or q - k < window]
            pairs += len(keys)
            seen |= {k // ps for k in keys}
        pages += len(seen)
    H, Hkv, hd = heads
    assert flops == 4 * H * hd * pairs
    assert nbytes == pages * (2 * ps * Hkv * hd * 2 + ps * 4) + 2 * len(pos) * C * H * hd * 2


def test_token_flops_count_active_experts_only():
    cfg = dict(hidden_size=4096, intermediate_size=14336, num_attention_heads=32,
               num_key_value_heads=8, head_dim=128, num_local_experts=8,
               num_experts_per_tok=2, num_hidden_layers=1, vocab_size=32000)
    experts = 2 * 3 * 2 * 4096 * 14336
    attn = 2 * 4096 * 48 * 128 + 2 * 4096 * 4096
    assert WK.token_matmul_flops(cfg) == experts + attn + 2 * 4096 * 8 + 2 * 4096 * 32000
