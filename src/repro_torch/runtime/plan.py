"""Step plans: what each sequence does in one engine step (port of the
reference's ``runtime/plan.py``).

One serving step mixes *decode items* (one token for a running row) and
*prefill chunks* (``[lo, hi)`` of an admitting request's prompt, written
into its slot's KV pages at that offset).  :class:`StepPlan` describes
such a mixed batch; :class:`TokenBudgetPolicy` builds one per step under
a hard token budget, so a long prompt never head-of-line-blocks the
running decodes.

Invariants (the reference's, property-tested there):

* a plan never exceeds ``token_budget`` tokens;
* a request's chunks come in order and partition its prompt;
* every running row decodes every step (prefill spends the surplus);
* the first admission always makes progress: the constructor refuses
  budgets below ``chunk_size + max_rows``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Sequence


@dataclass
class ChunkTask:
    """One prefill chunk ``[lo, hi)`` of one request's prompt."""

    rid: int
    slot: int
    lo: int
    hi: int
    last: bool  # final chunk: sample the first token, row joins decode


@dataclass
class Admission:
    """Engine-side record of a request being prefilled into its slot,
    chunk by chunk: straight into its pages, or on dense slot KV into a
    B = 1 row state that is installed after the last chunk."""

    rid: int
    slot: int
    total: int              # prompt length
    next_lo: int = 0
    state: Any = None       # dense slot KV: the B = 1 row state
    req: Any = None         # engine-side request handle

    @property
    def done(self) -> bool:
        return self.next_lo >= self.total


@dataclass
class StepPlan:
    """The mixed batch one engine step executes."""

    decode_rows: List[int] = field(default_factory=list)
    chunks: List[ChunkTask] = field(default_factory=list)

    @property
    def prefill_tokens(self) -> int:
        return sum(c.hi - c.lo for c in self.chunks)

    @property
    def total_tokens(self) -> int:
        return len(self.decode_rows) + self.prefill_tokens


@dataclass(frozen=True)
class TokenBudgetPolicy:
    """Per-step token budget packing decode rows + prefill chunks.

    Decode rows are always scheduled (each costs 1); the rest of the
    budget is filled with prefill chunks in admission order, each
    ``chunk_size`` tokens except a request's final remainder."""

    chunk_size: int
    token_budget: int
    max_rows: int  # engine slot count: bounds the decode-row reserve

    def __post_init__(self):
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got "
                             f"{self.chunk_size}")
        floor = self.chunk_size + self.max_rows
        if self.token_budget < floor:
            raise ValueError(
                f"token_budget={self.token_budget} cannot make progress: "
                f"needs >= chunk_size + max_rows = {floor} so one chunk "
                f"always fits beside a full decode batch")

    def plan(self, decode_rows: Sequence[int],
             admissions: Sequence[Admission]) -> StepPlan:
        plan = StepPlan(decode_rows=list(decode_rows))
        budget = self.token_budget - len(plan.decode_rows)
        for adm in admissions:
            lo = adm.next_lo
            while lo < adm.total:
                take = min(self.chunk_size, adm.total - lo)
                if take > budget:
                    break
                plan.chunks.append(ChunkTask(
                    rid=adm.rid, slot=adm.slot, lo=lo, hi=lo + take,
                    last=(lo + take) >= adm.total))
                budget -= take
                lo += take
            if lo < adm.total:
                break  # keep admission order: don't leapfrog a stalled one
        return plan
