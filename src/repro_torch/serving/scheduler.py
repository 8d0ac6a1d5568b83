"""Continuous-batching scheduler: admission queue + expert-aware policy
(port of the reference's ``serving/scheduler.py``).

Requests are submitted at any time; the engine asks the scheduler for the
next request whenever a slot frees up.  Which waiting request joins is a
*policy* decision:

* :func:`fcfs_policy`: arrival order;
* :class:`ExpertOverlapPolicy`: scores each waiting request by the
  predicted overlap between the experts it is about to route to and the
  experts the running batch keeps hot
  (``core/offload_engine.ExpertUsageTracker``).  Predictions reuse the
  paper's speculative gate trick (``core/speculative.predict_experts``):
  every MoE layer's router applied to the embedding of the request's last
  prompt token.

The scheduler never touches model state; slot bookkeeping lives in
``serving/kv_manager`` and the decode loop in ``serving/engine``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import speculative
from repro_torch.core.offload_engine import ExpertUsageTracker
from repro_torch.core.trace import stacked_routers

_rid_counter = itertools.count()

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"

# finish_reason -> terminal status.  Reasons not in the map are failures.
TERMINAL_STATUS = {"length": "completed", "eos": "completed",
                   "cancelled": "cancelled", "deadline": "deadline_exceeded",
                   "rejected": "rejected"}


@dataclass(eq=False)  # identity equality: the prompt array is unhashable
class GenRequest:
    """One generation request's lifecycle record."""

    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    rid: int = field(default_factory=lambda: next(_rid_counter))
    arrival: int = 0  # engine step at which the request became visible
    on_token: Optional[Callable[["GenRequest", int], None]] = None
    on_finish: Optional[Callable[["GenRequest"], None]] = None
    state: str = WAITING
    slot: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None  # a TERMINAL_STATUS key
    # per-request sampling temperature (None = the engine sampler's)
    temperature: Optional[float] = None
    # filled lazily by ExpertOverlapPolicy (per-layer predicted expert ids)
    _pred_experts: Optional[List[np.ndarray]] = None

    def emit(self, tok: int) -> None:
        self.generated.append(tok)
        if self.on_token is not None:
            self.on_token(self, tok)

    def finish(self, reason: str) -> None:
        self.state = FINISHED
        self.finish_reason = reason
        if self.on_finish is not None:
            self.on_finish(self)

    @property
    def status(self) -> Optional[str]:
        """Terminal status, None while in flight."""
        if self.state != FINISHED:
            return None
        return TERMINAL_STATUS.get(self.finish_reason, "failed")


# ----------------------------------------------------------------------
@dataclass(frozen=True)
class AdmissionCost:
    """State footprint one request claims at admission, by plane."""

    kv_positions: int           # growing-KV positions the engine reserves
    kv_positions_windowed: int  # same, with swa layers clamped to window
    rec_state_bytes: int        # fixed recurrent state (flat in context)
    enc_kv_bytes: int           # shared read-only encoder KV


def admission_cost(cfg: ModelConfig, prompt_len: int,
                   max_new_tokens: int) -> AdmissionCost:
    """What admitting one request costs on an attention-only stack (the
    port's block kinds): every position of prompt + max_new on the KV
    plane, no recurrent state, no encoder KV."""
    from repro_torch.models.transformer import attention_window
    need = prompt_len + max_new_tokens
    windows = [attention_window(cfg, k) for k in cfg.layer_kinds()]
    return AdmissionCost(
        kv_positions=need,
        kv_positions_windowed=max(min(need, w) if w else need
                                  for w in windows),
        rec_state_bytes=0, enc_kv_bytes=0)


# ----------------------------------------------------------------------
# Admission policies: (waiting, usage) -> index into waiting
def fcfs_policy(waiting: Sequence[GenRequest],
                usage: Optional[ExpertUsageTracker]) -> int:
    return 0


class ExpertOverlapPolicy:
    """Pick the waiting request whose predicted experts overlap most with
    the running batch's hot experts; FCFS breaks ties."""

    needs_usage = True  # makes the engine collect per-step routing

    def __init__(self, params, cfg: ModelConfig, n_spec: int = 2):
        assert cfg.moe is not None, "expert-overlap policy needs an MoE arch"
        self.cfg = cfg
        self.n_spec = min(n_spec, cfg.moe.num_experts)
        self.routers = stacked_routers(params, cfg)  # (L_moe, D, E)
        self.embed = params["embed"]["table"]

    def _predict(self, req: GenRequest) -> List[np.ndarray]:
        if req._pred_experts is None:
            h = self.embed[int(req.prompt[-1])][None]  # (1, D)
            req._pred_experts = [
                speculative.predict_experts(self.routers[l], h,
                                            self.n_spec)[0].cpu().numpy()
                for l in range(self.routers.shape[0])]
        return req._pred_experts

    def __call__(self, waiting: Sequence[GenRequest],
                 usage: Optional[ExpertUsageTracker]) -> int:
        if usage is None or len(waiting) == 1:
            return 0
        scores = [usage.overlap(self._predict(r)) for r in waiting]
        return int(np.argmax(scores))  # argmax takes the first tie: FCFS


# ----------------------------------------------------------------------
class Scheduler:
    """Admission queue with pluggable policy and invariant accounting."""

    def __init__(self, max_slots: int, policy: Optional[Callable] = None,
                 queue_cap: Optional[int] = None):
        self.max_slots = max_slots
        self.policy = policy or fcfs_policy
        if queue_cap is not None and queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1 (got {queue_cap}); "
                             f"None means unbounded")
        self.queue_cap = queue_cap
        self.waiting: List[GenRequest] = []
        self.running: List[GenRequest] = []
        self.finished: List[GenRequest] = []
        self.joins = 0
        self.evictions = 0
        self.queue_rejected = 0

    def submit(self, req: GenRequest) -> bool:
        """Enqueue ``req``; False = the bounded queue is full (the request
        was not retained; the caller owns the rejection)."""
        assert req.state == WAITING
        if self.queue_cap is not None and len(self.waiting) >= self.queue_cap:
            self.queue_rejected += 1
            return False
        self.waiting.append(req)
        return True

    @property
    def has_waiting(self) -> bool:
        return bool(self.waiting)

    @property
    def n_running(self) -> int:
        return len(self.running)

    def peek_next(self, usage: Optional[ExpertUsageTracker] = None):
        """Policy-selected waiting request WITHOUT admitting it: the engine
        checks the pick's KV need before committing a slot, then passes
        the index to :meth:`pop_at` (the policy runs once per admission)."""
        assert self.waiting and len(self.running) < self.max_slots
        idx = self.policy(self.waiting, usage)
        return idx, self.waiting[idx]

    def pop_at(self, idx: int) -> GenRequest:
        """Admit the waiting request at ``idx`` (from :meth:`peek_next`)."""
        req = self.waiting.pop(idx)
        req.state = RUNNING
        self.running.append(req)
        self.joins += 1
        return req

    def evict(self, req: GenRequest, reason: str) -> None:
        self.running.remove(req)
        req.finish(reason)
        self.finished.append(req)
        self.evictions += 1

    def drop(self, req: GenRequest, reason: str) -> None:
        """Terminal exit for a waiting request (cancellation)."""
        self.waiting.remove(req)
        req.finish(reason)
        self.finished.append(req)

    def metrics(self) -> dict:
        return {"joins": self.joins, "evictions": self.evictions,
                "finished": len(self.finished),
                "waiting": len(self.waiting),
                "running": len(self.running),
                "queue_rejected": self.queue_rejected}

    def check_invariants(self) -> None:
        assert len(self.running) <= self.max_slots
        slots = [r.slot for r in self.running]
        assert len(slots) == len(set(slots)), "duplicate slot assignment"
        assert all(r.state == RUNNING for r in self.running)
        assert all(r.state == WAITING for r in self.waiting)
        assert all(r.state == FINISHED for r in self.finished)
