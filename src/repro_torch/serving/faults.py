"""Deterministic fault injection (port of the reference's
``serving/faults.py``, kept as the port's own copy).

A :class:`FaultInjector` holds a schedule of :class:`FaultSpec` entries
keyed by *site*, and the engine, the executor and the KV manager ask
``fires(site)`` at each natural failure boundary.  Everything is
host-side: the device work of a faulty run is the same as a fault-free
run's, which is what lets survivors be held to the fault-free tokens.

Sites:

``expert_fetch``
    A transient failure of one MoE layer's expert fetch at the pool's
    acquire boundary (``core.expert_pool.FAULT_SITE``).  The executor
    retries, then runs that layer store-direct through the prefill tier.
``swap_out`` / ``swap_in``
    A preemption's d2h stage fails (the KV is dropped and the request
    resumes by recompute) / a resume's h2d stage fails (the blob is
    discarded and the request resumes by recompute).
``page_pool``
    Admission sees no headroom although pages are free; it retries at the
    next step.
``nan_logits``
    One decode row's logits are poisoned with NaN before sampling; the
    quarantine fails that row alone.
``slow_step``
    A wall-clock stall (``stall_ms``) at the start of a step.

Each site draws from its own ``np.random.default_rng([seed, site
index])`` stream, one draw per rate-eligible opportunity, so two runs
with the same schedule, seed and workload fire identically, and a site's
stream does not depend on how often the others are consulted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["SITES", "FaultSpec", "FaultInjector"]

# the site order: a site's index keys its random stream
SITES = ("expert_fetch", "swap_out", "swap_in", "page_pool",
         "nan_logits", "slow_step")


@dataclass(frozen=True)
class FaultSpec:
    """One site's schedule.

    ``rate``      Bernoulli fire probability per opportunity.
    ``at``        opportunity ordinals (0-based) that fire whatever the
                  rate.
    ``max_fires`` cap on the fires (None: no cap); ``at`` fires count.
    ``start``     opportunities before this ordinal never fire by rate.
    ``stall_ms``  for ``slow_step``: how long the stall sleeps.
    """
    site: str
    rate: float = 0.0
    at: Tuple[int, ...] = ()
    max_fires: Optional[int] = None
    start: int = 0
    stall_ms: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {', '.join(SITES)}")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        object.__setattr__(self, "at", tuple(int(i) for i in self.at))


class FaultInjector:
    """Seeded, schedule-driven fault source.  ``fires(site)`` counts one
    opportunity at ``site`` and says whether the fault fires; sites
    without a schedule entry never fire and never draw."""

    def __init__(self, schedule: Sequence[FaultSpec] = (), seed: int = 0):
        self.seed = int(seed)
        self.schedule: Dict[str, FaultSpec] = {}
        for spec in schedule:
            if spec.site in self.schedule:
                raise ValueError(f"duplicate schedule entry for site "
                                 f"{spec.site!r}")
            self.schedule[spec.site] = spec
        self._rng = {s: np.random.default_rng([self.seed, i])
                     for i, s in enumerate(SITES)}
        self.opportunities = {s: 0 for s in SITES}
        self.fired = {s: 0 for s in SITES}

    def fires(self, site: str) -> bool:
        """One opportunity at ``site``: did the fault fire?"""
        n = self.opportunities[site]          # KeyError: a misspelt site
        self.opportunities[site] = n + 1
        spec = self.schedule.get(site)
        if spec is None:
            return False
        if spec.max_fires is not None and self.fired[site] >= spec.max_fires:
            return False
        hit = n in spec.at
        if not hit and spec.rate > 0.0 and n >= spec.start:
            # one draw per rate-eligible opportunity keeps the stream
            # aligned across runs whatever the ``at`` hits
            hit = bool(self._rng[site].random() < spec.rate)
        if hit:
            self.fired[site] += 1
        return hit

    def stall_ms(self, site: str = "slow_step") -> float:
        spec = self.schedule.get(site)
        return spec.stall_ms if spec is not None else 0.0

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())

    def stats(self) -> Dict[str, int]:
        out: Dict[str, int] = {"injected": self.total_fired}
        for s in SITES:
            out[f"fired_{s}"] = self.fired[s]
        return out

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultInjector":
        """The schedule grammar: comma-separated site specs, each
        ``site[@i][@j]...[=rate][:stall_ms]``::

            expert_fetch=0.05           5% of fetches fail (transient)
            nan_logits@2                poison the 3rd decode sample pass
            swap_out@0,swap_in=1.0      first d2h fails; every h2d fails
            slow_step@5:25              25 ms stall at step 5
        """
        specs = []
        for part in filter(None, (p.strip() for p in text.split(","))):
            stall = 0.0
            if ":" in part:
                part, ms = part.rsplit(":", 1)
                stall = float(ms)
            rate = 0.0
            if "=" in part:
                part, r = part.split("=", 1)
                rate = float(r)
            fields = part.split("@")
            site, at = fields[0].strip(), tuple(int(i) for i in fields[1:])
            specs.append(FaultSpec(site=site, rate=rate, at=at,
                                   stall_ms=stall))
        return cls(specs, seed=seed)
