"""Paper Fig. 2 (left): LRU cache hit ratio against cache size k.

The trained ``tiny-moe``'s routing trace (top-2 of 8 experts, held-out
corpus text) replayed through the LRU cache at each k, and beside it the
decayed-LFU cache and the clairvoyant Belady bound at k 2 and 4 (the
port of the reference's ``benchmarks/fig2_lru.py``)."""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.core.lru_cache import lru_hit_curve, policy_comparison


def run(quick=False, device=None):
    tr = common.get_trace(128 if quick else None, device=device)
    ks = [1, 2, 3, 4, 6, 8]
    curve = lru_hit_curve(tr["ids"], ks)
    rows = []
    for k in ks:
        rows.append({
            "name": f"fig2_lru_hit_ratio_k{k}",
            "us_per_call": "",
            "derived": f"{curve[k]:.4f}",
            "k": k,
            "hit_ratio": curve[k],
        })
    # paper-claim check: hit ratio rises steeply then saturates; k=E is ~1
    rows.append({
        "name": "fig2_lru_monotone",
        "derived": str(all(curve[a] <= curve[b] + 1e-9
                           for a, b in zip(ks, ks[1:]))),
    })
    comp = policy_comparison(tr["ids"], [2, 4])
    for (pol, k), v in sorted(comp.items()):
        rows.append({"name": f"fig2ext_{pol}_k{k}", "us_per_call": "",
                     "derived": f"{v:.4f}", "policy": pol, "k": k,
                     "hit_ratio": v})
    common.emit(rows, "fig2_lru")
    return rows


if __name__ == "__main__":
    run()
