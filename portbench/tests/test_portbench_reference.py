"""The plain reference held against the program on the CPU: its forward
against the port's plain plane (``generate_plain``) and its packed plane
(the harness's engine, ``OffloadEngine.generate``), on small Mixtral- and
Granite-shaped configurations in float32; and the frozen HQQ copy
against the port's."""
import numpy as np
import pytest
import torch

from portbench import harness as H, weights as W
from portbench.reference import hqq as RH, moe_decoder as REF
from portbench.tests.conftest import small

NAMES = ("mixtral-offload", "granite-moe-1b-a400m")
# float32 on the CPU: the same products in another order
F32_GAP = 1e-4


def _gap(cfg, seed, prompts, served):
    ref = REF.logits(cfg, seed, [list(p) + list(s) for p, s in zip(prompts, served)],
                     [len(p) for p in prompts], "cpu")
    return max(float((lg.max(-1).values - lg[torch.arange(len(s)), torch.as_tensor(s)]).max())
               for lg, s in zip(ref, served))


def _prompts(cfg, n=2, S=9):
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg["vocab_size"], S) for _ in range(n)]


def _plain_params(cfg, seed):
    """The seed's weights as the port's dense parameter tree: experts
    dequantized, the output projections as the program's set-up makes
    them (the frozen quantizer; the packed test checks that against the
    program's own)."""
    d = W.dense(cfg, seed, "cpu")
    L = cfg["num_hidden_layers"]
    d.update(REF.shared_weights(cfg, d))
    params = {"embed": {"table": d["embed"]}, "final_norm": {"scale": d["norms"][2 * L]},
              "layers": []}
    if not cfg["tie_word_embeddings"]:
        params["lm_head"] = {"w": d["lm_head"]}
    for l in range(L):
        params["layers"].append({
            "norm1": {"scale": d["norms"][2 * l]},
            "attn": {k: d[k][l] for k in ("wq", "wk", "wv", "wo")},
            "norm2": {"scale": d["norms"][2 * l + 1]},
            "moe": {"router": d["router"][l],
                    "experts": REF.layer_experts(cfg, seed, l, "cpu")}})
    return params


@pytest.mark.parametrize("name", NAMES)
def test_reference_holds_generate_plain(name):
    from repro_torch.core.offload_engine import generate_plain
    cfg, seed = small(name), 11
    pcfg = H.port_config(cfg)
    params = _plain_params(cfg, seed)
    prompts = _prompts(cfg)
    served = [generate_plain(params, pcfg, p[None], 10, device="cpu")[0] for p in prompts]
    assert _gap(cfg, seed, prompts, served) <= F32_GAP


@pytest.mark.parametrize("name", NAMES)
def test_reference_holds_packed_plane(name):
    cfg, seed = small(name), 12
    eng = H.build_engine(cfg, seed, "cpu", "packed_pipelined")
    prompts = _prompts(cfg)
    served = [eng.generate(p[None], 10)[0][0] for p in prompts]
    assert _gap(cfg, seed, prompts, served) <= F32_GAP


@pytest.mark.parametrize("bits", (2, 3, 4))
def test_frozen_hqq_is_the_programs(bits):
    from repro_torch.quant import hqq
    w = torch.randn(2, 256, 48, generator=torch.Generator().manual_seed(bits)) * 0.05
    qt = hqq.quantize(w, bits)
    ours = RH.quantize_dequantize(w, bits)
    assert torch.equal(ours, hqq.dequantize(qt))
    assert torch.equal(
        RH.dequantize(qt.packed, qt.scale, qt.zero, qt.meta, bits, qt.group_size, qt.shape),
        hqq.dequantize(qt))


@pytest.mark.cuda
def test_frozen_hqq_is_the_programs_on_the_card(cuda_device):
    """On the card, at a Mixtral expert stack's shape, the frozen quantizer
    gives the program's weights bit for bit: the reference works out the
    same experts the program packs."""
    from repro_torch.core import expert_pool as EP
    from repro_torch.quant import hqq
    cfg = small("mixtral-offload", hidden_size=4096, intermediate_size=14336,
                num_local_experts=2, torch_dtype="bfloat16")
    raw = W.experts(cfg, 2**31 + 7, 0, cuda_device)
    qts = EP.quantize_experts(raw, 2)
    ours = REF.layer_experts(cfg, 2**31 + 7, 0, cuda_device)
    for m in W.EXPERT_MATS:
        assert torch.equal(ours[m], hqq.dequantize(qts[m])), m


def test_control_precision_reads_worse():
    """The float8 control's first choices lie further below the reference's
    best than the float32 program's tokens do."""
    from portbench import judge
    cfg, seed = small("mixtral-offload"), 13
    eng = H.build_engine(cfg, seed, "cpu", "packed_pipelined")
    prompts = _prompts(cfg, n=3, S=12)
    served = [eng.generate(p[None], 16)[0][0] for p in prompts]
    g = judge.gaps(cfg, seed, prompts, served, "cpu", control=True)
    assert g["served_gap"] <= F32_GAP
    assert g["control"]["served_gap"] > 100 * max(g["served_gap"], F32_GAP / 100)
    assert g["control"]["mean_gap"] > 100 * max(g["mean_gap"], F32_GAP / 1e4)


@pytest.mark.parametrize("window", (None, 5))
def test_attention_in_query_blocks_is_the_whole(window):
    """A long prompt's scores are taken a block of queries at a time: the
    same attention as all at once."""
    cfg = small("mixtral-offload", sliding_window=window)
    g = torch.Generator().manual_seed(4)
    D, H, Hkv, hd = 64, 4, 2, 16
    x = torch.randn(23, D, generator=g)
    w = [torch.randn(D, n, hd, generator=g) / 8 for n in (H, Hkv, Hkv)]
    wo = torch.randn(H, hd, D, generator=g) / 8
    ops = REF._Ops("f32")
    whole = REF._attention(ops, x, *w, wo, cfg, q_block=64)
    blocks = REF._attention(ops, x, *w, wo, cfg, q_block=4)
    assert torch.allclose(whole, blocks, atol=1e-6)
