"""How ``correct`` is decided: the served tokens against the plain reference.

Once the window has closed and the program's state is freed, the
reference runs once over each sampled request's prompt and served tokens
(``portbench/reference``, float32, TF32 off, weights drawn again from the
seed) and the judge reads, at every served position, the gap by which
the served token's reference logit lies below the reference's best.
Greedy decoding serves the best token of its own arithmetic, so the gap
measures how far that arithmetic strays.  Two numbers are read from the
gaps: ``served_gap``, the widest, and ``mean_gap``, their mean over the
positions (a sound program leaves most positions at 0 and parts from
the reference only at near-ties; a coarser one, on many positions).
Each cell's limits are ``portbench/limits/<cell>.json``: an upper limit
for each number it compares and ``min_positions``, with the readings
they were set from in PERF.md.

The control (``portbench/control.py``, never run by the benchmark's own
runs) reads the same numbers for the tokens that the reference computed
in float8 e4m3 puts first, at the same positions, and holds them to the
same :func:`decide`.
"""
from __future__ import annotations

from typing import Sequence

import torch

from portbench.reference import moe_decoder as REF


def _numbers(g: torch.Tensor) -> dict:
    return {"served_gap": float(g.max()), "mean_gap": float(g.mean()),
            "positions": int(g.numel())}


def gaps(cfg: dict, seed: int, prompts: Sequence, served: Sequence, device,
         control: bool = False) -> dict:
    """The judge's numbers of the served tokens; with ``control``, also
    ``control``: the same numbers of the float8 reference's first
    choices at the same positions, and both sides' gaps at every
    position (``served_gaps``, ``control_gaps``, request by request)."""
    seqs = [list(map(int, p)) + list(map(int, s)) for p, s in zip(prompts, served)]
    starts = [len(p) for p in prompts]
    ref = REF.logits(cfg, seed, seqs, starts, device)
    sg = [lg.max(-1).values
          - lg.gather(-1, torch.as_tensor(list(map(int, s)), device=lg.device)[:, None])[:, 0]
          for lg, s in zip(ref, served)]
    out = _numbers(torch.cat(sg))
    if control:
        low = REF.logits(cfg, seed, seqs, starts, device, precision="fp8")
        cg = [lg.max(-1).values - lg.gather(-1, lw.argmax(-1)[:, None])[:, 0]
              for lg, lw in zip(ref, low)]
        out["control"] = _numbers(torch.cat(cg))
        out["served_gaps"] = [g.tolist() for g in sg]
        out["control_gaps"] = [g.tolist() for g in cg]
    return out


def decide(numbers: dict, limits: dict):
    """``(correct, checks)``: each number that ``limits`` names at or under
    its limit, and at least ``min_positions`` positions compared;
    ``checks`` holds each compared number beside its limit."""
    checks = {k: {"value": numbers[k], "limit": v}
              for k, v in limits.items() if k != "min_positions"}
    checks["positions_compared"] = {"value": numbers["positions"],
                                    "limit": limits["min_positions"]}
    correct = (all(c["value"] <= c["limit"] for k, c in checks.items()
                   if k != "positions_compared")
               and numbers["positions"] >= limits["min_positions"])
    return correct, checks
