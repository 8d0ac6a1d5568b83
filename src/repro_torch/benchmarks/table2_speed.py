"""Paper Table 2, for the card this port runs on: decode tokens/s of
Mixtral-8x7B with {2-bit, 3-bit} experts under the paper's four
policies (full algorithm, without pre-loading, without LRU and
pre-loading, naive per-layer streaming).

The cache statistics are measured: the trained ``tiny-moe``'s routing
trace replayed through the policies at the paper's operating point (k 4,
2 speculative), per-layer rates scaled to Mixtral's 32 MoE layers.  The
tokens/s are the cost model's on the one hardware row,
``cost_model.HARDWARE["h100"]``, whose constants were measured on an
NVIDIA H100 80GB HBM3 at 700 W.  Unlike the reference's file, this one
states no other card's numbers: neither the paper's tokens/s on A100,
RTX 3080 Mobile, RTX 3060 and T4 nor an ordering across cards."""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.configs import get_config
from repro_torch.core import cost_model as C


def run(quick=False, device=None):
    tr = common.get_trace(128 if quick else None, device=device)
    mixtral = get_config("mixtral-8x7b")
    stats = C.replay_policies(tr["ids"], tr["hiddens"], tr["routers"],
                              k=4, n_spec=2, lookahead=1)
    # tiny-moe has 6 MoE layers; per-layer rates are what the trace
    # measures, so scale the per-token counts to Mixtral's 32
    layer_scale = mixtral.moe_layer_count / tr["ids"].shape[1]
    stats = {pol: C.TokenStats(*(v * layer_scale for v in
                                 (ts.demand_loads, ts.spec_loads,
                                  ts.hits, ts.spec_hits)))
             for pol, ts in stats.items()}
    rows = []
    ours = {}
    for bits in (2, 3):
        for pol, ts in stats.items():
            for hw_name, hw in C.HARDWARE.items():
                tps = C.tokens_per_second(mixtral, hw, ts, bits,
                                          naive=(pol == "naive"))
                ours[(bits, pol, hw_name)] = tps
                rows.append({
                    "name": f"table2_{bits}bit_{pol}_{hw_name}",
                    "us_per_call": f"{1e6 / tps:.0f}",
                    "derived": f"tok/s={tps:.3f}",
                    "bits": bits, "policy": pol, "hw": hw_name,
                    "tokens_per_s": round(tps, 3),
                })
    # every policy level improves throughput (per hardware row, 2-bit)
    ok = all(ours[(2, "full", h)] > ours[(2, "no_spec", h)]
             > ours[(2, "no_lru_no_spec", h)] > ours[(2, "naive", h)]
             for h in C.HARDWARE)
    rows.append({"name": "table2_policy_ordering", "derived": str(ok)})
    print(f"[table2] table2_policy_ordering: {ok}")
    ts = stats["full"]
    rows.append({
        "name": "table2_measured_stats_full",
        "derived": (f"demand/tok={ts.demand_loads:.2f};"
                    f"spec_hits/tok={ts.spec_hits:.2f};"
                    f"hits/tok={ts.hits:.2f};spec_loads/tok={ts.spec_loads:.2f}"),
    })
    common.emit(rows, "table2_speed")
    return rows


if __name__ == "__main__":
    run()
