"""Paper Fig. 2 (right): speculative-loading recall against the number of
experts fetched, for gate lookaheads of 1, 2 and 5 layers (the port of
the reference's ``benchmarks/fig2_spec.py``).

recall@n = the fraction of layer l+j's active experts covered when layer
l+j's gate is applied to layer l's hidden state and its top n fetched."""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.core.speculative import recall_curve


def run(quick=False, device=None):
    tr = common.get_trace(128 if quick else None, device=device)
    n_layers = tr["ids"].shape[1]
    lookaheads = [j for j in (1, 2, min(5, n_layers - 1)) if j < n_layers]
    n_fetch = [1, 2, 3, 4, 6, 8]
    rec = recall_curve(tr["hiddens"], tr["routers"], tr["ids"],
                       lookaheads, n_fetch)
    rows = []
    for j in lookaheads:
        for n in n_fetch:
            rows.append({
                "name": f"fig2_spec_recall_ahead{j}_fetch{n}",
                "us_per_call": "",
                "derived": f"{rec[(j, n)]:.4f}",
                "lookahead": j, "n_fetch": n, "recall": rec[(j, n)],
            })
    # paper claims: recall grows with n; nearer lookahead is better
    r1 = [rec[(1, n)] for n in n_fetch]
    rows.append({"name": "fig2_spec_monotone_in_n",
                 "derived": str(all(b >= a - 1e-9
                                    for a, b in zip(r1, r1[1:])))})
    if len(lookaheads) >= 2:
        j2 = lookaheads[1]
        rows.append({
            "name": "fig2_spec_nearer_lookahead_better",
            "derived": str(rec[(1, 2)] >= rec[(j2, 2)] - 0.02),
        })
    common.emit(rows, "fig2_spec")
    return rows


if __name__ == "__main__":
    run()
