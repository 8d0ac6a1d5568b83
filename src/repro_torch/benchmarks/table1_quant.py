"""Paper Table 1: the mixed quantization grid, (attention bits x expert
bits) -> quality and model size (the port of the reference's
``benchmarks/table1_quant.py``).

Quality is the trained ``tiny-moe``'s held-out byte cross-entropy with
its weights HQQ-quantized (``quantize_for_offload``, dequantized back to
dense) and evaluated by the training forward; 16 bits means left
unquantized.  Sizes are projected to Mixtral-8x7B's parameter counts
(the paper's 86.99 -> 17.3 GB column)."""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.configs import get_config
from repro_torch.configs.base import OffloadSpec
from repro_torch.core.cost_model import EFFECTIVE_BITS
from repro_torch.core.offload_engine import quantize_for_offload
from repro_torch.models.transformer import count_params_analytic
from repro_torch.quant.hqq import tree_leaves
from repro_torch.training.trainer import eval_ce


def mixtral_size_gb(attn_bits, expert_bits):
    """Project the scheme to Mixtral-8x7B parameter counts (Table 1)."""
    cfg = get_config("mixtral-8x7b")
    total = count_params_analytic(cfg)
    experts = cfg.moe_layer_count * cfg.moe.num_experts * 3 * cfg.d_model * cfg.d_ff
    emb = cfg.vocab_size * cfg.d_model  # embeddings stay fp16 (tied)
    attn = total - experts - emb
    return (experts * EFFECTIVE_BITS[expert_bits] / 8
            + attn * EFFECTIVE_BITS[attn_bits] / 8 + emb * 2) / 1e9


def run(quick=False, device=None):
    params, cfg = common.get_trained_tiny_moe(device=device)
    dev = tree_leaves(params)[0].device
    eval_b = list(common.recipe_dataset().eval_batches(2 if quick else 4))
    rows = []
    grid_attn = [16, 4] if quick else [16, 4, 3, 2]
    grid_exp = [16, 4, 2] if quick else [16, 4, 3, 2]
    base_ce = eval_ce(params, cfg, eval_b)
    for ab in grid_attn:
        for eb in grid_exp:
            if ab == 16 and eb == 16:
                ce = base_ce
            else:
                # 16 means "not quantized": quantize at 8 bits, then put
                # the original leaves back
                spec = OffloadSpec(expert_bits=eb if eb != 16 else 8,
                                   attn_bits=ab if ab != 16 else 8)
                qp, _ = quantize_for_offload(params, cfg, spec, device=dev)
                if eb == 16:
                    qp = _restore(qp, params, lambda path: "experts" in path)
                if ab == 16:
                    qp = _restore(qp, params, _is_shared)
                ce = eval_ce(qp, cfg, eval_b)
            gb = mixtral_size_gb(ab, eb)
            rows.append({
                "name": f"table1_attn{ab}_exp{eb}",
                "us_per_call": "",
                "derived": f"ce={ce:.4f};mixtral_gb={gb:.2f}",
                "attn_bits": ab, "expert_bits": eb,
                "eval_ce": ce, "mixtral_proj_gb": gb,
                "delta_ce_vs_fp": ce - base_ce,
            })
            print(f"[table1] attn={ab} exp={eb}: ce {ce:.4f} "
                  f"(+{ce - base_ce:.4f}) mixtral {gb:.1f}GB")
    # structural claims from the paper's Table 1
    get = lambda ab, eb: next(r for r in rows if r["attn_bits"] == ab
                              and r["expert_bits"] == eb)
    checks = []
    if not quick:
        # quality monotone in expert bits at fixed attention bits
        checks.append(("table1_exp_bits_monotone",
                       get(4, 2)["eval_ce"] >= get(4, 4)["eval_ce"] - 1e-3))
        # the two single-side deltas, for the write-up
        checks.append(("table1_attn4exp16_delta",
                       round(get(4, 16)["delta_ce_vs_fp"], 4)))
        checks.append(("table1_attn16exp4_delta",
                       round(get(16, 4)["delta_ce_vs_fp"], 4)))
    for nm, val in checks:
        rows.append({"name": nm, "derived": str(val)})
    common.emit(rows, "table1_quant")
    return rows


_SHARED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _is_shared(path):
    """A quantized shared weight: attention or dense-MLP, not an expert."""
    return path[-1] in _SHARED and "experts" not in path


def _restore(qtree, orig, pick):
    """``qtree`` with the leaves whose path ``pick`` selects taken from
    ``orig``."""
    def walk(a, b, path):
        if isinstance(a, dict):
            return {k: walk(a[k], b[k], path + (k,)) for k in a}
        if isinstance(a, list):
            return [walk(x, y, path + (str(i),))
                    for i, (x, y) in enumerate(zip(a, b))]
        return b if pick(path) else a
    return walk(qtree, orig, ())


if __name__ == "__main__":
    run()
