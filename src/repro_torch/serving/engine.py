"""Serving engines (port of the reference's ``serving/engine.py``).

* :class:`ServeEngine`: a static batch.  Prompts are left-padded to a
  common length and prefilled together through the full-sequence forward
  (``Executor.prefill_padded``: pads masked out of attention and of MoE
  dispatch capacity), then decoded in lock-step, each row from its own
  true length, until every row has hit its budget or EOS.
* :class:`ContinuousEngine`: continuous batching.  Requests join and
  leave a *running* batch of ``max_slots`` sequences at independent
  positions.  The KV plane is dense slot rings (``kv_page=None``,
  :class:`~repro_torch.serving.kv_manager.KVSlotManager`: admission
  prefills each prompt into a fresh B = 1 row state, installed into its
  slot after the last chunk) or block pages (``kv_page``,
  ``PagedKVManager``: admission writes each chunk straight into the
  slot's pages).  Prompts are admitted one whole prompt per step by
  default, or in budgeted chunks with ``prefill_chunk``
  (``runtime.TokenBudgetPolicy``); every step then decodes one token for
  every running row in one batched ``Executor`` decode.  Weights are the
  plain plane's dense resident ones, or, with ``offload``, the packed
  experts served from the offload engine's device pool, shared by the
  whole batch.  Which waiting request joins next is the scheduler
  policy's call (FCFS or expert overlap).  With a dense draft model
  (``draft_params``/``draft_cfg``, ``num_draft_tokens`` = k) greedy
  decode runs as draft-and-verify: each step the draft proposes up to k
  tokens per row and the target verifies every row's proposals in one C
  = k + 1 chunk, then each row's KV rolls back past its rejection point
  (:meth:`ContinuousEngine._step_speculative`); the tokens are those of
  greedy decode.

Each step's positions, row indices, page table and ragged work list are
built on the host from the managers' tables and uploaded with the step's
tokens, so nothing is read back from the device but the sampled tokens
(on the plain plane, greedy: the (max_slots,) argmax) and, where routing
is needed (the packed planes, or a policy that reads usage), the routed
ids (in a draft-and-verify round: every row's C argmax values, after
the draft's own proposal reads).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, parse_block
from repro_torch.core.draft import verify_round
from repro_torch.core.offload_engine import (ExpertUsageTracker,
                                             routing_from_info)
from repro_torch.obs import SpecMetrics
from repro_torch.runtime.executor import Executor
from repro_torch.runtime.plan import (Admission, ChunkTask, StepPlan,
                                      TokenBudgetPolicy)
from repro_torch.serving.kv_manager import KVSlotManager, StateManager
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.scheduler import (GenRequest, Scheduler,
                                           admission_cost)

EOS = 258  # the reference's byte tokenizer: PAD, BOS, EOS = 256, 257, 258


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"ContinuousEngine: {what} is not ported yet (ROADMAP queue 1, "
        f"item {item})")


@dataclass
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    completed: List[int] = field(default_factory=list)


class ServeEngine:
    """The static batch engine (module docstring) on the plain plane,
    on the card unless ``device="cpu"``."""

    def __init__(self, params, cfg: ModelConfig,
                 sampler: Optional[SamplerConfig] = None, device=None):
        self.params = params
        self.cfg = cfg
        self.sampler = sampler or SamplerConfig(kind="greedy")
        self._exec = Executor(params, cfg, device=device)
        self.device = self._exec.device

    def serve_batch(self, requests: List[Request], seed: int = 0
                    ) -> List[Request]:
        """Left-pad the prompts to a common length, prefill them together
        and decode until every request has its ``max_new_tokens`` or has
        emitted EOS; tokens are appended to each ``completed``.  Pad
        isolation needs causal attention in every layer, so unequal
        lengths are refused on any other stack.  Sampling draws from a
        generator seeded with ``seed``."""
        cfg = self.cfg
        B = len(requests)
        S = max(len(r.prompt) for r in requests)
        needs_pad = any(len(r.prompt) != S for r in requests)
        if needs_pad and any(parse_block(k)[0] not in ("attn", "swa")
                             for k in cfg.layer_kinds()):
            raise ValueError(
                f"left-padded serve_batch needs a causal-attention stack; "
                f"{cfg.name}'s mixers accumulate state over pad tokens "
                f"- batch equal-length prompts for this arch")
        max_new = max(r.max_new_tokens for r in requests)
        toks = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), bool)
        for i, r in enumerate(requests):
            toks[i, S - len(r.prompt):] = r.prompt  # left-pad with 0
            mask[i, S - len(r.prompt):] = True
        batch = {"tokens": toks}
        if needs_pad:
            batch["pad_mask"] = mask
        pre_logits, state = self._exec.prefill_padded(batch, S + max_new)
        gen = torch.Generator(self.device)
        gen.manual_seed(seed)
        tok = sample(gen, pre_logits[:, -1], self.sampler)
        first = tok.cpu().numpy()
        done = np.zeros(B, bool)
        for i in range(B):
            requests[i].completed.append(int(first[i]))
        for _ in range(max_new - 1):
            logits, state, _, _ = self._exec.decode(state, tok[:, None])
            tok = sample(gen, logits[:, -1], self.sampler)
            host = tok.cpu().numpy()
            for i, r in enumerate(requests):
                if done[i] or len(r.completed) >= r.max_new_tokens:
                    done[i] = True
                    continue
                t = int(host[i])
                r.completed.append(t)
                if t == EOS:
                    done[i] = True
            if done.all():
                break
        return requests


class ContinuousEngine:
    """Continuous-batching decode loop over slotted KV (module
    docstring).

    ``params``: dense resident weights (the plain plane); ignored with
    ``offload``, the port's packed ``OffloadEngine``, whose executor,
    store, device and executable weights are used (the reference's
    offloaded mode).  ``kv_page``: page size of the paged plane (None:
    dense slot rings of ``slot_len``); ``kv_pages_total`` defaults to
    full provisioning, ``max_slots * ceil(slot_len / kv_page)``.
    ``ragged_bucket=False`` pins the paged step's table to full width.
    ``prefill_chunk``/``token_budget``: budgeted chunked admission.
    ``draft_params``/``draft_cfg``/``num_draft_tokens``: draft-and-verify
    decoding with a dense attention-only draft (greedy only).
    ``device``: the plain plane's device (the card unless ``"cpu"``)."""

    def __init__(self, params, cfg: ModelConfig, *, max_slots: int = 4,
                 slot_len: int = 256, sampler: Optional[SamplerConfig] = None,
                 policy=None, eos_id: Optional[int] = EOS,
                 prefill_chunk: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 seed: int = 0, offload=None,
                 kv_page: Optional[int] = None,
                 kv_pages_total: Optional[int] = None,
                 ragged_bucket: bool = True,
                 prefix_cache_pages: int = 0,
                 preemption: bool = False,
                 kv_host_pages: int = 0,
                 telemetry=None,
                 draft_params=None, draft_cfg=None,
                 num_draft_tokens: int = 0,
                 faults=None,
                 queue_cap: Optional[int] = None,
                 device=None):
        if prefix_cache_pages or preemption or kv_host_pages:
            raise _not_ported("prefix caching, preemption and host swap", 5)
        if faults is not None:
            raise _not_ported("fault injection", 5)
        if telemetry is not None:
            raise _not_ported("telemetry", 7)
        self.offload = offload
        self._pstate = None
        if offload is not None:
            if offload.cfg != cfg:
                raise ValueError("offload engine config mismatch")
            self._exec = offload._exec
            # a verify chunk brings max_slots * (k + 1) token rows
            self._pstate = self._exec.init_pool_state(
                max_rows=max_slots * (1 + int(num_draft_tokens or 0)))
            params = offload.params
        else:
            self._exec = Executor(params, cfg, device=device)
        self.device = self._exec.device
        self.params = params
        self.cfg = cfg
        self.sampler = sampler or SamplerConfig(kind="greedy")
        self._greedy = self.sampler.kind == "greedy"
        self.max_slots = max_slots
        self.eos_id = eos_id
        self.paged = kv_page is not None
        self.kv = StateManager.create(
            cfg, max_slots, slot_len, kv_page=kv_page,
            kv_pages_total=kv_pages_total, bucket=ragged_bucket,
            device=self.device)
        self.slot_len = self.kv.slot_len  # per-request cap, page-rounded
        self.sched = Scheduler(max_slots, policy, queue_cap=queue_cap)
        self.prefill_chunk = prefill_chunk
        self.budget: Optional[TokenBudgetPolicy] = None
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1")
            if prefill_chunk > self.slot_len:
                raise ValueError(f"prefill_chunk={prefill_chunk} exceeds "
                                 f"slot_len={self.slot_len}")
            self.budget = TokenBudgetPolicy(
                chunk_size=prefill_chunk,
                token_budget=token_budget or (max_slots + prefill_chunk),
                max_rows=max_slots)
        elif token_budget is not None:
            raise ValueError("token_budget needs prefill_chunk (the budget "
                             "schedules prompt chunks)")
        self._admissions: List[Admission] = []
        # routing costs a host read per MoE layer on the plain plane: read
        # it only where a policy scores by usage (the packed planes read
        # it every step anyway)
        self._collect = (cfg.moe is not None
                         and (getattr(policy, "needs_usage", False)
                              or offload is not None))
        self.usage = (ExpertUsageTracker.for_config(cfg)
                      if self._collect else None)
        # only sliding-window rings roll inside a dense slot, so on an
        # all-SWA stack whose slots hold the window a request may decode
        # past slot_len; pages are position-indexed and never roll
        mixers = {parse_block(k)[0] for k in cfg.layer_kinds()}
        self._unbounded = (not self.paged and mixers == {"swa"}
                           and bool(cfg.sliding_window)
                           and self.slot_len >= cfg.sliding_window)
        self.tokens = np.zeros((max_slots, 1), np.int32)
        self.step_count = 0
        self._gen = torch.Generator(self.device)
        self._gen.manual_seed(seed)
        self.spec_k = int(num_draft_tokens or 0)
        self.spec_metrics: Optional[SpecMetrics] = None
        if self.spec_k > 0:
            self._init_draft(draft_params, draft_cfg)

    def _init_draft(self, draft_params, draft_cfg) -> None:
        """Check and set up draft-and-verify decoding (the reference's
        checks): a dense attention-only draft sharing the vocabulary, a
        greedy engine, and requests bounded by a ring that never wraps."""
        cfg = self.cfg
        if draft_params is None or draft_cfg is None:
            raise ValueError("num_draft_tokens >= 1 needs draft_params "
                             "and draft_cfg (the dense draft model)")
        if not self._greedy:
            raise ValueError(
                "draft-and-verify decoding is greedy-only: the acceptance "
                "rule compares the target's argmax stream")
        # a wrapped ring cannot roll back: a rejected verify-chunk write
        # would overwrite the live entry W positions back.  Dense rings
        # are min(slot_len, window) wide; pages never wrap
        self._unbounded = False
        self._spec_cap = self.slot_len
        if (not self.paged and cfg.sliding_window
                and any(parse_block(k)[0] == "swa"
                        for k in cfg.block_pattern)):
            self._spec_cap = min(self.slot_len, cfg.sliding_window)
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}; draft and target must share tokens")
        if not draft_cfg.attention_only_stack or draft_cfg.moe is not None:
            raise ValueError(
                f"draft {draft_cfg.name!r} must be a dense causal-attention "
                f"stack (rollback = pos reset; an MoE draft would compete "
                f"for the h2d bus)")
        self._draft_exec = Executor(draft_params, draft_cfg,
                                    device=self.device)
        # k positions of headroom: rejected self-feeds land past the
        # canonical stream and must never wrap onto live context
        self._draft_kv = KVSlotManager(draft_cfg, self.max_slots,
                                       self.slot_len + self.spec_k,
                                       device=self.device)
        self._draft_consumed = np.zeros(self.max_slots, np.int64)
        # the request whose draft state each slot row holds (-1: none);
        # a row is bound lazily, at its first speculative step
        self._draft_rid = np.full(self.max_slots, -1, np.int64)
        self.spec_metrics = SpecMetrics()
        self._spec_last_h2d = 0.0

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32, on_token=None,
               on_finish=None, temperature: Optional[float] = None
               ) -> GenRequest:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        assert prompt.size > 0, "empty prompt"
        if temperature is not None and self._greedy:
            raise ValueError(
                "per-request temperature needs a stochastic sampler; this "
                "engine decodes greedily")
        cap = self.slot_len if self.spec_metrics is None else self._spec_cap
        if not self._unbounded and prompt.size + max_new_tokens > cap:
            detail = (f"slot_len={self.slot_len}" if cap == self.slot_len
                      else f"the speculative ring cap {cap} (= min(slot_"
                           f"len, sliding_window); a wrapped ring cannot "
                           f"roll back rejected verify chunks)")
            raise ValueError(
                f"request needs {prompt.size + max_new_tokens} KV "
                f"positions > {detail}")
        req = GenRequest(prompt=prompt, max_new_tokens=max_new_tokens,
                         arrival=self.step_count, on_token=on_token,
                         on_finish=on_finish, temperature=temperature)
        if not self.sched.submit(req):
            req.finish("rejected")  # bounded queue full: backpressure
        return req

    # ------------------------------------------------------------------
    def _sample_rows(self, logits, reqs: List[GenRequest]) -> np.ndarray:
        """logits (B, V) for exactly ``reqs`` rows -> (B,) int32."""
        if self._greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        temps = None
        if any(r.temperature is not None for r in reqs):
            temps = [self.sampler.temperature if r.temperature is None
                     else r.temperature for r in reqs]
        return sample(self._gen, logits, self.sampler,
                      temperature=temps).cpu().numpy()

    # ------------------------------------------------------------------
    # admission
    def _start_admissions(self) -> None:
        """Move policy-selected waiting requests into free slots.  On
        pages the pick must be able to reserve its worst case (prompt +
        max_new), else admission stalls until releases free pages (head
        of line on memory: no preemption); on dense slots it prefills
        into a fresh row state.  Prompts prefill as chunks."""
        while self.kv.n_free and self.sched.has_waiting:
            idx, cand = self.sched.peek_next(self.usage)
            state = None
            if self.paged:
                need = admission_cost(self.cfg, len(cand.prompt),
                                      cand.max_new_tokens).kv_positions
                if not self.kv.can_admit(need):
                    break
                req = self.sched.pop_at(idx)
                req.slot = self.kv.allocate(req.rid, need)
            else:
                req = self.sched.pop_at(idx)
                req.slot = self.kv.allocate(req.rid)
                state = self.kv.new_row_state()
            self._admissions.append(Admission(
                rid=req.rid, slot=req.slot, total=len(req.prompt),
                state=state, req=req))

    def _grow_running_rows(self, rows: List[int]) -> None:
        """Cover every decoding row's next position with a page before the
        step: the admission reservation guarantees it fits."""
        for r in rows:
            self.kv.ensure(r, self.kv.length(r) + 1)

    def _run_chunks(self, chunks: List[ChunkTask]) -> List[GenRequest]:
        """Run this step's prefill chunks: into the slot's pages, or into
        the admission's row state.  An admission whose final chunk ran
        samples its first token and joins the decode rows: this step when
        unchunked (a dense row is installed at once), the next step under
        a budget (a dense row is installed at that step's start, so this
        step's batched decode cannot advance a row it did not plan)."""
        finished = []
        by_rid = {a.rid: a for a in self._admissions}
        for task in chunks:
            adm = by_rid[task.rid]
            req: GenRequest = adm.req
            tokens = torch.as_tensor(req.prompt[None, task.lo: task.hi],
                                     device=self.device)
            if self.paged:
                self.kv.ensure(adm.slot, task.hi)
                logits, new_state = self._exec.prefill_chunk_row(
                    self.kv.view(), tokens, adm.slot)
                self.kv.adopt(new_state)
                self.kv.note_tokens(adm.slot, task.hi)
            else:
                logits, adm.state = self._exec.prefill_chunk(adm.state,
                                                             tokens)
            adm.next_lo = task.hi
            if not task.last:
                continue
            first = int(self._sample_rows(logits[:, -1], [req])[0])
            req.emit(first)
            if self._done(req, first):
                self._admissions.remove(adm)
                self._finish(req, self._reason(first))
                finished.append(req)
                continue
            self.tokens[adm.slot, 0] = first
            if self.paged:
                self._admissions.remove(adm)
            elif self.budget is None:
                self.kv.write_prefill(adm.state, adm.slot)
                self._admissions.remove(adm)
        return finished

    def _install_ready(self) -> None:
        """Dense slots under a budget: install the admissions whose final
        chunk ran last step; their rows join this step's decode."""
        for adm in [a for a in self._admissions if a.done]:
            self.kv.write_prefill(adm.state, adm.slot)
            self._admissions.remove(adm)

    def _plan(self) -> StepPlan:
        """This step's mixed batch: every decodable row + prompt chunks
        under the token budget (unchunked: whole prompts this step, split
        only at the slot width)."""
        self._install_ready()
        self._start_admissions()
        decode_rows = self._decode_rows()
        if self.budget is not None:
            return self.budget.plan(decode_rows, self._admissions)
        plan = StepPlan(decode_rows=decode_rows)
        for adm in self._admissions:
            # prompts longer than the ring (unbounded SWA) split at
            # slot_len, so no chunk overwrites itself
            for lo in range(adm.next_lo, adm.total, self.slot_len):
                hi = min(lo + self.slot_len, adm.total)
                plan.chunks.append(ChunkTask(rid=adm.rid, slot=adm.slot,
                                             lo=lo, hi=hi,
                                             last=hi >= adm.total))
        return plan

    def _decode_rows(self) -> List[int]:
        admitting = {a.rid for a in self._admissions}
        return sorted(r.slot for r in self.sched.running
                      if r.rid not in admitting)

    def _done(self, req: GenRequest, tok: int) -> bool:
        return (len(req.generated) >= req.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id))

    def _reason(self, tok: int) -> str:
        return ("eos" if self.eos_id is not None and tok == self.eos_id
                else "length")

    def _finish(self, req: GenRequest, reason: str) -> None:
        """A running request ends: its slot (and pages) and its draft row
        are released before the scheduler sees the eviction."""
        self.kv.release(req.slot)
        if self.spec_k > 0:
            self._draft_rid[req.slot] = -1
        self.sched.evict(req, reason)

    # ------------------------------------------------------------------
    def cancel(self, rid: int) -> bool:
        """Client abandonment: terminal status ``cancelled``, wherever the
        request is (waiting, mid-admission or running); its slot and pages
        are released.  False when the rid is unknown or already ended."""
        for req in self.sched.waiting:
            if req.rid == rid:
                self.sched.drop(req, "cancelled")
                return True
        self._admissions = [a for a in self._admissions if a.rid != rid]
        for req in self.sched.running:
            if req.rid == rid:
                self._finish(req, "cancelled")
                return True
        return False

    def check_invariants(self) -> None:
        """Step-boundary audit of the host-side bookkeeping: the
        scheduler's lists, the KV manager's free/owned partition and, with
        a draft, the draft rings' slot ledger."""
        self.sched.check_invariants()
        self.kv.check_invariants()
        if self.spec_metrics is not None:
            self._draft_kv.check_invariants()

    # ------------------------------------------------------------------
    def step(self) -> List[GenRequest]:
        """One engine step: the plan's prefill chunks, then one batched
        decode over the planned rows.  Returns the requests finished this
        step."""
        plan = self._plan()
        finished = self._run_chunks(plan.chunks)
        # unchunked admission: a request admitted this step decodes this
        # step; budgeted steps decode exactly the planned rows
        rows = (self._decode_rows() if self.budget is None
                else plan.decode_rows)
        if not rows:
            if plan.chunks:
                self.step_count += 1
            self.sched.check_invariants()
            return finished
        reqs = sorted((r for r in self.sched.running if r.slot in set(rows)),
                      key=lambda r: r.slot)
        if self.spec_metrics is not None:
            # one draft-and-verify round for the whole batch; k is clipped
            # so no row emits past its budget (a row with one token left
            # sends the batch to the plain step below)
            k_round = min([self.spec_k]
                          + [r.max_new_tokens - len(r.generated) - 1
                             for r in reqs])
            if k_round >= 1:
                return self._step_speculative(finished, rows, reqs, k_round)
        active = np.zeros((self.max_slots,), bool)
        active[rows] = True
        if self.paged:
            self._grow_running_rows(rows)
            step_state = self.kv.view(self.kv.live_width(rows))
        else:
            step_state = self.kv.state
        if self.offload is not None:
            # free slots bypass the expert pool: their dummy tokens never
            # touch the cache or the counters
            logits, state, self._pstate, route_ids = self._exec.decode(
                step_state, self.tokens, self._pstate, active)
            self.usage.update(route_ids, rows=rows)
            nxt_dev = logits[:, -1]
        else:
            out = self._exec.decode_sampled(
                step_state, self.tokens, collect_info=self._collect,
                greedy=self._greedy, active=active)
            nxt_dev, state = out[0], out[1]
            if self._collect:
                ids, _ = routing_from_info(self.cfg, out[2],
                                           want_hiddens=False)
                self.usage.update(ids, rows=rows)
        if self.paged:
            self.kv.adopt(state)
            for r in rows:
                self.kv.note_tokens(r, self.kv.length(r) + 1)
        else:
            self.kv.state = state
        if self._greedy and self.offload is None:
            nxt = nxt_dev.cpu().numpy()  # the step's one device read
        elif self._greedy:
            nxt = self._sample_rows(nxt_dev, reqs)  # every slot's row
        else:
            nxt = np.zeros((self.max_slots,), np.int32)
            nxt[rows] = self._sample_rows(nxt_dev[rows], reqs)
        for req in reqs:
            t = int(nxt[req.slot])
            req.emit(t)
            if self._done(req, t):
                self._finish(req, self._reason(t))
                finished.append(req)
            else:
                self.tokens[req.slot, 0] = t
        self.step_count += 1
        self.sched.check_invariants()
        return finished

    # ------------------------------------------------------------------
    # draft-and-verify decoding
    def _draft_admit(self, req: GenRequest) -> None:
        """Bind a running request to its slot's draft row: a B = 1 draft
        prefill of the prompt, installed at the draft ring's width.  Lazy:
        it runs at the first speculative step that touches the row, so
        every admission mode (whole, chunked, paged) binds alike."""
        slot = req.slot
        _, st = self._draft_exec.prefill(req.prompt[None],
                                         self._draft_kv.slot_len)
        self._draft_kv.write_prefill(st, slot)
        self._draft_consumed[slot] = req.prompt.size
        self._draft_rid[slot] = req.rid

    def _draft_propose(self, reqs: List[GenRequest], k: int
                       ) -> Dict[int, List[int]]:
        """Batched draft catch-up and proposal: every row first consumes
        its canonical tail (the tokens emitted since the draft last saw
        the stream), then proposes k greedy tokens, feeding itself the
        first k - 1.  The rows run in lock-step sub-steps of all
        ``max_slots`` rows; a row that is done parks one position past its
        last real feed (dead under the mask, overwritten when a real token
        lands there).  The draft's positions are host-authoritative, set
        from ``_draft_consumed`` before every sub-step (which also rolls
        rejected feeds back) and uploaded with the sub-step's tokens."""
        kvd = self._draft_kv
        queues: Dict[int, List[int]] = {}
        total: Dict[int, int] = {}
        fed: Dict[int, int] = {}
        props: Dict[int, List[int]] = {}
        for req in reqs:
            r = req.slot
            canon = np.concatenate([req.prompt.astype(np.int64),
                                    np.asarray(req.generated, np.int64)])
            q = [int(t) for t in canon[int(self._draft_consumed[r]):]]
            assert q, "draft ahead of the canonical stream"
            queues[r], total[r] = q, len(q) + k - 1
            fed[r], props[r] = 0, []
        state = kvd.state
        for _ in range(max(total.values())):
            toks = np.zeros((self.max_slots, 1), np.int32)
            pos = np.zeros((self.max_slots,), np.int32)
            for req in reqs:
                r = req.slot
                i = min(fed[r], total[r])  # done rows park one past last
                pos[r] = int(self._draft_consumed[r]) + i
                if fed[r] < len(queues[r]):
                    toks[r, 0] = queues[r][fed[r]]
                elif fed[r] < total[r]:
                    toks[r, 0] = props[r][fed[r] - len(queues[r])]
            logits, state, _, _ = self._draft_exec.decode(
                dict(state, pos=pos), toks)
            am = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            for req in reqs:
                r = req.slot
                if fed[r] < total[r]:
                    fed[r] += 1
                    if fed[r] >= len(queues[r]):
                        props[r].append(int(am[r]))
        kvd.state = state  # its pos is stale; _draft_consumed is the truth
        for req in reqs:
            self._draft_consumed[req.slot] += len(queues[req.slot])
        return props

    def _step_speculative(self, finished: List[GenRequest], rows: List[int],
                          reqs: List[GenRequest], k_round: int
                          ) -> List[GenRequest]:
        """One draft-and-verify round over the running rows: the draft
        proposes ``k_round`` tokens per row, the target verifies every
        row's in one C = k_round + 1 chunk (on the packed plane one pool
        acquire per MoE layer over the B * C token rows), each row emits
        its longest matching prefix plus the target's own next token, and
        the target's KV (``truncate``: a position reset on dense rings,
        the table trim on pages) and the draft's bookkeeping roll back
        past each row's rejection point."""
        C = k_round + 1
        for req in reqs:
            if self._draft_rid[req.slot] != req.rid:
                self._draft_admit(req)
        props = self._draft_propose(reqs, k_round)
        chunk = np.zeros((self.max_slots, C), np.int32)
        for req in reqs:
            chunk[req.slot, 0] = self.tokens[req.slot, 0]
            chunk[req.slot, 1:] = props[req.slot]
        active = np.zeros((self.max_slots,), bool)
        active[rows] = True
        base_len = {}
        if self.paged:
            for r in rows:
                base_len[r] = self.kv.length(r)
                self.kv.ensure(r, base_len[r] + C)
            step_state = self.kv.view(self.kv.live_width(rows))
        else:
            step_state = self.kv.state
        # the route ids are token-major (B * C, K): row r's at r * C + j
        tok_rows = [r * C + j for r in rows for j in range(C)]
        if self.offload is not None:
            logits, state, self._pstate, route_ids = self._exec.decode(
                step_state, chunk, self._pstate, active)
            self.usage.update(route_ids, rows=tok_rows)
        else:
            logits, state, _, infos = self._exec.decode(
                step_state, chunk, active=active, collect_info=self._collect)
            if self._collect:
                ids, _ = routing_from_info(self.cfg, infos,
                                           want_hiddens=False)
                self.usage.update(ids, rows=tok_rows)
        if self.paged:
            self.kv.adopt(state)
            for r in rows:
                self.kv.note_tokens(r, base_len[r] + C)
        else:
            self.kv.state = state
        # the round's one blocking read: every row's target argmax
        tgt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for req in reqs:
            r = req.slot
            emitted, a = verify_round(props[r], tgt[r])
            self.spec_metrics.round(k_round, a)
            stopped = False
            for t in emitted:
                req.emit(int(t))
                if self._done(req, int(t)):
                    stopped = True
                    break
            if stopped:
                self._finish(req, self._reason(req.generated[-1]))
                finished.append(req)
            else:
                # roll back to where non-speculative decode would stand:
                # prompt + generated, minus the last token not yet fed
                self.tokens[r, 0] = req.generated[-1]
                self.kv.truncate(r, len(req.prompt) + len(req.generated) - 1)
                self._draft_consumed[r] += min(a, k_round - 1)
        if self.offload is not None:
            total = (int(self._pstate.counts[2]) + int(self._pstate.counts[3])
                     ) * self.offload.expert_bytes
            self.spec_metrics.add_bytes(total - self._spec_last_h2d)
            self._spec_last_h2d = total
        self.step_count += 1
        self.sched.check_invariants()
        return finished

    def run(self, max_steps: Optional[int] = None) -> List[GenRequest]:
        """Drive until every submitted request finishes; returns them in
        completion order."""
        steps = 0
        while self.sched.has_waiting or self.sched.n_running:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.sched.finished

    # ------------------------------------------------------------------
    def _engine_metrics(self) -> Dict[str, float]:
        toks = sum(len(r.generated) for r in self.sched.finished)
        out = self.sched.metrics()
        out.update(steps=self.step_count, tokens=toks,
                   tokens_per_step=toks / max(1, self.step_count),
                   decode_tokens=toks + sum(len(r.generated)
                                            for r in self.sched.running))
        return out

    def _offload_metrics(self) -> Dict[str, float]:
        hits, spec_hits, demand, spec = (int(c) for c in self._pstate.counts)
        bytes_h2d = (demand + spec) * self.offload.expert_bytes
        emitted = sum(len(r.generated)
                      for r in self.sched.finished + self.sched.running)
        return {"hits": hits, "spec_hits": spec_hits,
                "demand_loads": demand, "spec_loads": spec,
                "bytes_h2d": bytes_h2d,
                "bytes_per_token": bytes_h2d / max(1, emitted)}

    def stats(self) -> Dict[str, float]:
        """The reference's flat ``stats()`` keys: engine counters bare,
        ``kv_*`` and, with an offload engine, ``offload_*``."""
        out = dict(self._engine_metrics())
        out.update(self.kv.stats())
        if self.offload is not None:
            out.update({f"offload_{k}": v
                        for k, v in self._offload_metrics().items()})
        return out
