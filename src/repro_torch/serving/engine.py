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
  (:meth:`ContinuousEngine._step_speculative`; a recurrent stack's rows
  by snapshot, restore and replay); the tokens are those of greedy
  decode.  On pages, a radix prefix cache lets requests that share
  a prompt prefix share its full pages and prefill from where they
  diverge, and preemption admits optimistically and, when the pool runs
  dry, swaps a victim's pages to pinned host memory (or drops them for a
  recompute) and resumes it later, with the same tokens.  A seeded fault
  plane (``serving/faults``) exercises the failure paths: a failed
  expert fetch is retried, then served store-direct; a NaN row is
  quarantined; a request can be cancelled, or run out its deadline,
  wherever it is.  An ``obs.Telemetry`` (``telemetry=``) adds the
  reference's telemetry plane: step phases, request spans, the roofline.
  An encoder-decoder's request brings its frontend's ``audio_embeds``
  (``submit(..., extras=)``): admission runs the encoder once
  (``Executor.encode``) into the slot's row of the encoder-KV plane (on
  pages before its first chunk, on dense slots into the row state that
  the install copies), and every step's cross-attention reads it.

Each step's positions, row indices, page table and ragged work list are
built on the host from the managers' tables and uploaded with the step's
tokens, so nothing is read back from the device but the sampled tokens
(on the plain plane, greedy: the (max_slots,) argmax; under the fault
plane the (max_slots, V) last logits) and, where routing
is needed (the packed planes, or a policy that reads usage), the routed
ids (in a draft-and-verify round: every row's C argmax values, after
the draft's own proposal reads).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, parse_block
from repro_torch.core.draft import verify_round
from repro_torch.core.offload_engine import (ExpertUsageTracker,
                                             routing_from_info)
from repro_torch.obs import SpecMetrics, Telemetry, jit_cache_metrics
from repro_torch.runtime.executor import Executor
from repro_torch.runtime.plan import (Admission, ChunkTask, StepPlan,
                                      TokenBudgetPolicy)
from repro_torch.serving.faults import SITES as FAULT_SITES
from repro_torch.serving.kv_manager import KVSlotManager, StateManager
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.scheduler import (RUNNING, GenRequest, Scheduler,
                                           admission_cost)

EOS = 258  # the reference's byte tokenizer: PAD, BOS, EOS = 256, 257, 258


@dataclass
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    completed: List[int] = field(default_factory=list)


@dataclass
class _Swapped:
    """A preempted request off the device: its pages staged to the host
    (``blob``), or dropped for a recompute resume (``blob`` None)."""

    req: GenRequest
    blob: Optional[dict]
    next_tok: Optional[int]  # the pending (emitted) token to feed; None:
                             # an admission dropped before its first token
    n_tokens: int         # live KV positions at the preemption
    seq: int              # FIFO order within a priority


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
        if cfg.is_encoder_decoder:
            raise ValueError(
                f"{cfg.name} is encoder-decoder: serve_batch takes no audio "
                f"input (audio_embeds); serve it through ContinuousEngine, "
                f"whose submit() takes extras={{'audio_embeds': ...}}")
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

    On pages only: ``prefix_cache_pages`` keeps up to that many full
    prompt pages in a radix prefix index (``serving/prefix_cache``), and
    a request whose prompt hits adopts them and prefills from where it
    diverges; ``preemption`` admits on the prompt's pages and grows page
    by page, and when the pool runs dry (or a higher-priority request
    waits) preempts a victim, whose pages go to a host pool of
    ``kv_host_pages`` pages and come back on resume, or, when the budget
    cannot hold them (always at 0), are dropped and rebuilt by
    re-prefilling prompt + generated.  Not with drafts.

    ``faults``: a seeded ``serving.faults.FaultInjector`` (the fault
    plane): a failed expert fetch is retried ``fetch_retries`` times
    (``fetch_backoff_ms`` apart), then the layer runs store-direct;
    page-pool and swap faults take the stall and recompute paths; a NaN
    row is quarantined (status ``failed``); ``slow_step`` stalls.  With
    an injector every decode step reads the last logits to the host.
    ``check_invariants=True`` runs :meth:`check_invariants` after every
    step.  ``queue_cap`` bounds the waiting queue (a request submitted to
    a full queue ends ``rejected``).  ``deadline_ms`` is the default
    wall-clock budget of a request; ``submit``'s ``deadline_ms`` /
    ``deadline_steps`` override it.  ``device``: the plain plane's device
    (the card unless ``"cpu"``).

    ``telemetry``: an ``obs.Telemetry``; with timing, per-step phases
    (``step``: plan, chunk, dispatch, sync = the step's token read,
    sample, host), the executor's dispatch phases (``exec``), request
    lifecycles (``request``, and spans with ``trace``) and the roofline.
    Default ``Telemetry.off()``: only the pull-time collectors behind
    :meth:`metrics` / :meth:`stats`; the tokens are the same either
    way."""

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
                 check_invariants: bool = False,
                 queue_cap: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 fetch_retries: int = 2,
                 fetch_backoff_ms: float = 0.0,
                 device=None):
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
        # the fault plane and the request lifecycle
        self.faults = faults
        self._check_inv = bool(check_invariants)
        self._deadline_ms = deadline_ms
        self._nan_quarantined = 0
        self._exec.set_fault_injector(faults, max_retries=fetch_retries,
                                      backoff_ms=fetch_backoff_ms)
        if self.paged:
            self.kv.set_fault_injector(faults)
        # prefix reuse and preemption
        self._prefix: Optional[PrefixCache] = None
        self._preempt = bool(preemption)
        self._swapped: List[_Swapped] = []
        self._swap_seq = 0
        self._recomputes = 0
        self._prefills_skipped = 0
        self._prefix_hit_tokens = 0
        if prefix_cache_pages or preemption or kv_host_pages:
            if not self.paged:
                raise ValueError(
                    "prefix caching / preemption need block-paged KV (set "
                    "kv_page); dense rings have no shareable or swappable "
                    "page unit")
            if not cfg.attention_only_stack:
                raise ValueError(
                    f"prefix caching / preemption need a causal-attention "
                    f"stack: {cfg.name!r} carries state that pages neither "
                    f"share nor swap")
            if kv_host_pages and not preemption:
                raise ValueError("kv_host_pages without preemption would "
                                 "never be used: enable preemption or drop "
                                 "the host pool")
            if preemption and num_draft_tokens:
                raise ValueError(
                    "preemption composes with plain decode only: a "
                    "draft-and-verify round holds un-verified KV that a "
                    "mid-round swap would tear")
        if prefix_cache_pages:
            self._prefix = PrefixCache(self.kv.page_size, prefix_cache_pages)
        if preemption:
            self.kv.enable_host_swap(kv_host_pages)
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
        # only growing planes consume positions: sliding-window rings roll
        # inside a dense slot, so on an all-SWA stack whose slots hold the
        # window a request may decode past slot_len, and a pure-recurrent
        # stack has no growing plane at all; pages are position-indexed
        # and never roll
        kv_mixers = {sp.mixer for sp in cfg.state_planes() if sp.grows}
        self._unbounded = (not self.paged
                           and (not kv_mixers
                                or (kv_mixers == {"swa"}
                                    and bool(cfg.sliding_window)
                                    and self.slot_len >= cfg.sliding_window)))
        self._has_rec = cfg.has_recurrent_layers
        self.tokens = np.zeros((max_slots, 1), np.int32)
        self.step_count = 0
        self._gen = torch.Generator(self.device)
        self._gen.manual_seed(seed)
        self._init_telemetry(telemetry)
        self.spec_k = int(num_draft_tokens or 0)
        self.spec_metrics: Optional[SpecMetrics] = None
        if self.spec_k > 0:
            self._init_draft(draft_params, draft_cfg)

    def _init_telemetry(self, telemetry) -> None:
        """The telemetry plane: the collectors always (they run only at
        snapshot time and back :meth:`stats`); timing, the executor's
        observer and the roofline only with an enabled ``Telemetry``."""
        self.obs = telemetry if telemetry is not None else Telemetry.off()
        reg = self.obs.registry
        reg.register_collector("engine", self._engine_metrics)
        reg.register_collector("kv", self.kv.metrics)
        reg.register_collector("jit", jit_cache_metrics)
        reg.register_collector("faults", self._faults_metrics)
        if self.offload is not None:
            reg.register_collector("offload", self._offload_metrics)
        if self._prefix is not None:
            reg.register_collector("prefix", self._prefix_metrics)
        if self._preempt:
            reg.register_collector("kv_host", self._kv_host_metrics)
        # the dispatch phases of this engine's decode steps (None without
        # timing); passed per call, as executors are shared
        self._phases = self.obs.exec_observer(self._exec.plane)
        if not self.obs.timing:
            return
        self.obs.declare_step_schema()
        self.obs.declare_request_schema()
        off = self.offload
        if off is None:
            self.obs.attach_roofline(self.cfg)
            return
        q = off.quantized
        self.obs.attach_roofline(
            self.cfg, expert_bits=off.spec.expert_bits if q else 16,
            attn_bits=off.spec.attn_bits if q else 16,
            expert_bytes=off.expert_bytes,
            # the pool's counters live on the host: no device read
            h2d_counts_fn=lambda: tuple(int(c) for c in self._pstate.counts))

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
        if self._has_rec and (self.paged or self.offload is not None):
            raise ValueError(
                f"draft-and-verify on {cfg.name!r} needs the dense plain "
                f"engine: recurrent carries roll back by a snapshot of the "
                f"pre-round row state and a restore, which the page-table "
                f"trim and the packed step do not carry")
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
        self.spec_metrics = SpecMetrics(self.obs.registry)
        self._spec_last_h2d = 0.0

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32, on_token=None,
               on_finish=None, temperature: Optional[float] = None,
               extras: Optional[dict] = None, priority: int = 0,
               deadline_ms: Optional[float] = None,
               deadline_steps: Optional[int] = None) -> GenRequest:
        """Queue a request.  An encoder-decoder needs ``extras={
        "audio_embeds": (S_e, d_model) or (1, S_e, d_model)}``, kept as
        float32 (1, S_e, d_model) and encoded at admission."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        assert prompt.size > 0, "empty prompt"
        if self._preempt:
            # optimistic admission must still end: a request whose worst
            # case exceeds the whole pool could preempt every other one
            # and still run dry mid-decode
            worst = self.kv.pool.pages_for(prompt.size + max_new_tokens)
            if worst > self.kv.pool.n_pages:
                raise ValueError(
                    f"request needs {worst} pages > pool total "
                    f"{self.kv.pool.n_pages}; even preemption cannot make "
                    f"it fit")
        if self.cfg.is_encoder_decoder:
            if not extras or "audio_embeds" not in extras:
                raise ValueError(
                    f"{self.cfg.name} is encoder-decoder: submit() needs "
                    f"extras={{'audio_embeds': (S_e, d_model)}}, encoded "
                    f"once at admission into the read-only shared "
                    f"encoder-KV plane")
            ae = np.asarray(extras["audio_embeds"], np.float32)
            if ae.ndim == 2:
                ae = ae[None]
            if ae.shape[0] != 1 or ae.shape[1] != self.cfg.encoder_seq:
                raise ValueError(
                    f"audio_embeds must be (S_e={self.cfg.encoder_seq}, "
                    f"d_model) for one request; got {ae.shape}")
            extras = dict(extras, audio_embeds=ae)
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
                         on_finish=on_finish, temperature=temperature,
                         extras=extras, priority=priority,
                         deadline_ms=(deadline_ms if deadline_ms is not None
                                      else self._deadline_ms),
                         deadline_steps=deadline_steps,
                         submit_ns=time.perf_counter_ns())
        self.obs.req_submitted(req.rid, self.step_count)
        if not self.sched.submit(req):
            req.finish("rejected")  # bounded queue full: backpressure
            self.obs.req_finished(req.rid, 0, "rejected")
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
        max_new), else admission stalls until releases free pages; under
        preemption it reserves its prompt + 1 and a stalled pick may
        preempt a strictly lower-priority row, and preempted requests
        resume first.  A prefix hit's pages count as credit and its
        prefill starts where it diverges.  On dense slots a request
        prefills into a fresh row state.  Prompts prefill as chunks.  An
        encoder-decoder's request is encoded here, once: into its slot's
        row of the plane on pages, into its row state on dense slots."""
        while self.kv.n_free and (self.sched.has_waiting or self._swapped):
            if not self.paged:
                req = self.sched.pop_next(self.usage)
                self.obs.req_admitted(req.rid, self.step_count - req.arrival)
                req.slot = self.kv.allocate(req.rid)
                state = self.kv.new_row_state()
                if self.cfg.is_encoder_decoder:
                    state["enc_kv"] = self._exec.encode(
                        req.extras["audio_embeds"])
                self._admissions.append(Admission(
                    rid=req.rid, slot=req.slot, total=len(req.prompt),
                    state=state, req=req))
                continue
            if self._swapped:
                sw = min(self._swapped, key=lambda s: (-s.req.priority, s.seq))
                pick = (self.sched.peek_next(self.usage)[1]
                        if self.sched.has_waiting else None)
                if pick is None or sw.req.priority >= pick.priority:
                    if not self._try_resume():
                        break  # no new admission past a stuck resume
                    continue
                # a strictly higher-priority arrival admits first: resuming
                # its own victim here would hand back the pages just freed
            idx, cand = self.sched.peek_next(self.usage)
            need = admission_cost(self.cfg, len(cand.prompt),
                                  cand.max_new_tokens).kv_positions
            base, shared = self._prefix_lookup(cand.prompt)
            reserve = len(cand.prompt) + 1 if self._preempt else need
            if not self.kv.can_admit(reserve, len(shared)):
                if self._make_room(cand):
                    continue  # look up again: eviction may drop its pages
                break
            req = self.sched.pop_at(idx)
            self.obs.req_admitted(req.rid, self.step_count - req.arrival)
            req.slot = self.kv.allocate(req.rid, reserve,
                                        shared_pages=shared, base=base)
            self._note_prefix_hit(base)
            if self.cfg.is_encoder_decoder:
                self.kv.write_enc_kv(
                    req.slot, self._exec.encode(req.extras["audio_embeds"]))
            self._admissions.append(Admission(
                rid=req.rid, slot=req.slot, total=len(req.prompt),
                next_lo=base, req=req))

    # ------------------------------------------------------------------
    # prefix reuse and preemption
    def _prefix_lookup(self, tokens):
        if self._prefix is None:
            return 0, []
        return self._prefix.lookup(np.asarray(tokens))

    def _note_prefix_hit(self, base: int) -> None:
        if base:
            self._prefills_skipped += 1
            self._prefix_hit_tokens += base
            if self.obs.roofline is not None:
                self.obs.roofline.add_prefix_hit(base)

    def _note_swap(self, blob: dict) -> None:
        """One swap's bytes (either way) into the roofline's tally."""
        if self.obs.roofline is not None:
            self.obs.roofline.add_swap_bytes(
                blob["n_pages"] * self.kv.page_nbytes())

    def _prefix_insert(self, tokens, slot: int) -> None:
        """Index the slot's full prompt pages once its prefill finished
        (they are immutable from then on: later writes land past them).
        The registered pages gain the cache's reference BEFORE the evicted
        ones are released: an insert that overflows the capacity may evict
        a node it just registered."""
        n_full = len(tokens) // self.kv.page_size
        if not n_full:
            return
        pids = self.kv.pool.owned[slot][:n_full]
        registered, evicted = self._prefix.insert(np.asarray(tokens), pids)
        for pid in registered:
            self.kv.pool.incref(pid)
        if evicted:
            self.kv.free_cached_pages(evicted)

    def _evict_prefix_pages(self) -> int:
        """Evict LRU prefix nodes until a device page actually frees (a
        page other slots still map frees nothing); returns the number
        freed, 0 when the cache is exhausted."""
        if self._prefix is None:
            return 0
        while True:
            pids = self._prefix.evict_lru()
            if not pids:
                return 0
            freed = self.kv.free_cached_pages(pids)
            if freed:
                return len(freed)

    def _pick_victim(self, exclude_slot: Optional[int] = None,
                     max_priority: Optional[int] = None
                     ) -> Optional[GenRequest]:
        """The lowest-priority, latest-arrival running row (admitting rows
        excluded: a half-prefilled slot has nothing consistent to swap).
        ``max_priority`` admits only STRICTLY lower priorities (an
        admission or resume never preempts its own class); decode growth
        passes none (it must proceed)."""
        admitting = {a.rid for a in self._admissions}
        cands = [r for r in self.sched.running
                 if r.rid not in admitting and r.slot != exclude_slot
                 and (max_priority is None or r.priority < max_priority)]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.priority, -r.arrival, -r.rid))

    def _preempt_req(self, req: GenRequest) -> None:
        """Take a running row off the device: its pages staged to the host
        pool when the budget holds them, else dropped for a recompute
        resume; either way they free for the beneficiary."""
        slot = req.slot
        n_live = self.kv.length(slot)
        blob = self.kv.swap_out(slot)  # None: drop and recompute
        if blob is not None:
            self._note_swap(blob)
        self.kv.release(slot)
        self.sched.preempt(req)
        self._swap_seq += 1
        self._swapped.append(_Swapped(
            req=req, blob=blob, next_tok=int(self.tokens[slot, 0]),
            n_tokens=n_live, seq=self._swap_seq))
        req.slot = None

    def _make_room(self, cand: Optional[GenRequest] = None) -> bool:
        """Free device pages for a stalled admission or resume: prefix
        eviction first (cached pages are speculative capital), then, under
        preemption, a strictly lower-priority victim.  True when pages
        were freed."""
        if self._evict_prefix_pages():
            return True
        if not self._preempt:
            return False
        victim = self._pick_victim(
            max_priority=cand.priority if cand is not None else None)
        if victim is None:
            return False
        self._preempt_req(victim)
        return True

    def _try_resume(self) -> bool:
        """Re-admit the best swapped request (priority, then preemption
        order).  Staged pages are copied back (h2d) and the row decodes
        on; dropped KV re-prefills prompt + generated[:-1] through the
        admission chunks (with prefix credit) and feeds the pending token
        instead of sampling.  A ``swap_in`` fault discards the blob and
        falls back to the recompute."""
        sw = min(self._swapped, key=lambda s: (-s.req.priority, s.seq))
        req = sw.req
        if (sw.blob is not None and self.faults is not None
                and self.faults.fires("swap_in")):
            self.kv.discard_blob(sw.blob)
            sw.blob = None
        if sw.blob is not None:
            while not self.kv.can_admit(sw.n_tokens + 1):
                if not self._make_room(req):
                    return False
            req.slot = self.kv.swap_in(req.rid, sw.blob, sw.n_tokens + 1)
            self._note_swap(sw.blob)
            self.sched.resume(req)
            self.tokens[req.slot, 0] = sw.next_tok
            self._swapped.remove(sw)
            return True
        ext = np.concatenate(
            [req.prompt, np.asarray(req.generated[:-1], np.int32)])
        n_live = len(ext)
        base, shared = self._prefix_lookup(ext)
        while not self.kv.can_admit(n_live + 1, len(shared)):
            if not self._make_room(req):
                return False
            base, shared = self._prefix_lookup(ext)  # eviction-safe redo
        req.slot = self.kv.allocate(req.rid, n_live + 1,
                                    shared_pages=shared, base=base)
        self.sched.resume(req)
        self._recomputes += 1
        self._note_prefix_hit(base)
        self._admissions.append(Admission(
            rid=req.rid, slot=req.slot, total=n_live, next_lo=base, req=req,
            tokens=ext, resume_tok=sw.next_tok))
        self._swapped.remove(sw)
        return True

    def _grow_running_rows(self) -> None:
        """Under preemption: secure every running row's next position
        BEFORE the plan forms (a preemption mid-step would tear a row the
        plan scheduled).  Rows grow best first (priority down, arrival
        up), so the rows not yet grown are the preferred victims."""
        admitting = {a.rid for a in self._admissions}
        rows = sorted((r for r in self.sched.running
                       if r.rid not in admitting),
                      key=lambda r: (-r.priority, r.arrival, r.rid))
        for req in rows:
            if req.state != RUNNING:
                continue  # already taken as an earlier row's victim
            n = self.kv.length(req.slot) + 1
            while not self.kv.can_grow(req.slot, n):
                if self._evict_prefix_pages():
                    continue
                victim = self._pick_victim(exclude_slot=req.slot)
                if victim is not None:
                    self._preempt_req(victim)
                    continue
                adm = self._pick_admission_victim()
                if adm is None:
                    raise RuntimeError(
                        "page pool exhausted with nothing left to preempt "
                        "(submit() checks that a lone request fits)")
                self._preempt_admission(adm)
            self.kv.grow(req.slot, n)

    def _pick_admission_victim(self) -> Optional[Admission]:
        """The lowest-priority, latest-arrival row still admitting: the
        victim of decode growth when no decoding row is left (F4 of the
        ROADMAP: its reservation holds the free pages, and the reference
        raises here)."""
        if not self._admissions:
            return None
        return min(self._admissions, key=lambda a: (
            a.req.priority, -a.req.arrival, -a.req.rid))

    def _preempt_admission(self, adm: Admission) -> None:
        """Drop a half-prefilled admission: its partial KV and its
        reservation are released, and it waits among the swapped requests
        (ahead of new arrivals of its priority) for a recompute from its
        prompt, or from prompt + generated[:-1] when it was itself a
        recompute resume; its pending token, if any, is fed again."""
        req = adm.req
        self._admissions.remove(adm)
        self.kv.release(adm.slot)
        self.sched.preempt(req)
        self._swap_seq += 1
        self._swapped.append(_Swapped(
            req=req, blob=None, next_tok=adm.resume_tok, n_tokens=0,
            seq=self._swap_seq))
        req.slot = None

    # ------------------------------------------------------------------
    def _run_chunks(self, chunks: List[ChunkTask]) -> List[GenRequest]:
        """Run this step's prefill chunks: into the slot's pages, or into
        the admission's row state.  An admission whose final chunk ran
        publishes its full pages to the prefix cache, then samples its
        first token (a recompute resume feeds its pending token instead)
        and joins the decode rows: this step when unchunked (a dense row
        is installed at once), the next step under a budget (a dense row
        is installed at that step's start, so this step's batched decode
        cannot advance a row it did not plan).  Under the fault plane a
        non-finite first-token row fails before it ever decodes."""
        finished = []
        by_rid = {a.rid: a for a in self._admissions}
        for task in chunks:
            adm = by_rid[task.rid]
            req: GenRequest = adm.req
            t0 = self.obs.clock_ns() if self.obs.tracer is not None else 0
            src = adm.tokens if adm.tokens is not None else req.prompt
            tokens = torch.as_tensor(src[None, task.lo: task.hi],
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
            self.obs.req_chunk(req.rid, task.lo, task.hi, t0)
            adm.next_lo = task.hi
            if not task.last:
                continue
            if self._prefix is not None:
                # before any release below: the cache's reference must
                # outlive the slot
                self._prefix_insert(src, adm.slot)
            if adm.resume_tok is not None:
                self.tokens[adm.slot, 0] = int(adm.resume_tok)
                self._admissions.remove(adm)
                continue
            if self.faults is not None and not bool(
                    torch.isfinite(logits[0, -1]).all()):
                self._nan_quarantined += 1
                self._admissions.remove(adm)
                self._finish(req, "nan")
                finished.append(req)
                continue
            first = int(self._sample_rows(logits[:, -1], [req])[0])
            req.emit(first)
            if self._done(req, first):
                self._admissions.remove(adm)
                self._finish(req, self._reason(first))
                finished.append(req)
                continue
            self.obs.req_decode_start(req.rid)
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
        only at the slot width).  Under preemption every running row's
        next position is secured first."""
        if self._preempt:
            self._grow_running_rows()
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
        self.obs.req_finished(req.rid, len(req.generated), reason)

    # ------------------------------------------------------------------
    # the request lifecycle
    def _terminate(self, rid: int, reason: str) -> bool:
        """End one in-flight request wherever it is (waiting, mid-
        admission, running or swapped out), releasing its slot, pages,
        draft row or host blob.  The prefix-cache references its prompt
        registered stay: cached pages are the cache's."""
        for req in self.sched.waiting:
            if req.rid == rid:
                self.sched.drop(req, reason)
                self.obs.req_finished(rid, len(req.generated), reason)
                return True
        for adm in self._admissions:
            if adm.rid == rid:
                self._admissions.remove(adm)
                self._finish(adm.req, reason)
                return True
        for req in self.sched.running:
            if req.rid == rid:
                self._finish(req, reason)
                return True
        for sw in self._swapped:
            if sw.req.rid == rid:
                self._swapped.remove(sw)
                self.kv.discard_blob(sw.blob)
                self.sched.drop(sw.req, reason)
                self.obs.req_finished(rid, len(sw.req.generated), reason)
                return True
        return False

    def cancel(self, rid: int) -> bool:
        """Client abandonment: terminal status ``cancelled``, callable
        between steps, wherever the request is; every resource it held is
        released.  False when the rid is unknown or already ended."""
        return self._terminate(rid, "cancelled")

    def _expire_deadlines(self) -> None:
        """End the requests past their wall-clock (``deadline_ms``) or
        engine-step (``deadline_steps``) budget, wherever they are."""
        cands = [r for r in (self.sched.waiting + self.sched.running
                             + [sw.req for sw in self._swapped])
                 if r.deadline_ms is not None or r.deadline_steps is not None]
        if not cands:
            return
        now = time.perf_counter_ns()
        for req in cands:
            over = (req.deadline_steps is not None
                    and self.step_count - req.arrival >= req.deadline_steps)
            if (not over and req.deadline_ms is not None
                    and req.submit_ns is not None):
                over = (now - req.submit_ns) > req.deadline_ms * 1e6
            if over:
                self._terminate(req.rid, "deadline")

    def _quarantine(self, last: np.ndarray, reqs: List[GenRequest],
                    finished: List[GenRequest]) -> List[GenRequest]:
        """``last``: the step's (max_slots, V) last-position logits on the
        host.  A ``nan_logits`` fault poisons the lowest-rid decode row;
        every non-finite row fails (status ``failed``) and is released.
        The other rows' logits are untouched.  Returns the survivors."""
        if reqs and self.faults.fires("nan_logits"):
            last[min(reqs, key=lambda r: r.rid).slot, :] = np.nan
        finite = np.isfinite(last).all(axis=-1)
        bad = [r for r in reqs if not finite[r.slot]]
        for req in bad:
            self._nan_quarantined += 1
            self._finish(req, "nan")
            finished.append(req)
        return [r for r in reqs if finite[r.slot]]

    def _audit_step(self) -> None:
        if self._check_inv:
            self.check_invariants()
        else:
            self.sched.check_invariants()

    def check_invariants(self) -> None:
        """Step-boundary audit of the host-side bookkeeping: the
        scheduler's lists, the KV manager's free/referenced partition with
        exact per-page refcounts (the prefix cache's included), the draft
        rings' slot ledger, and the host pool's occupancy equal to the
        pages the swapped requests staged."""
        self.sched.check_invariants()
        self.kv.check_invariants(
            self._prefix.pages() if self._prefix is not None else ())
        if self.spec_metrics is not None:
            self._draft_kv.check_invariants()
        host = getattr(self.kv, "host", None)
        if host is not None:
            staged = sum(sw.blob["n_pages"] for sw in self._swapped
                         if sw.blob is not None)
            assert host.in_use == staged, \
                f"host pool holds {host.in_use} pages but swapped " \
                f"requests staged {staged}"

    # ------------------------------------------------------------------
    def step(self) -> List[GenRequest]:
        """One engine step: the plan's prefill chunks, then one batched
        decode over the planned rows.  Returns the requests finished this
        step."""
        if self.faults is not None and self.faults.fires("slow_step"):
            time.sleep(self.faults.stall_ms() / 1e3)
        self._expire_deadlines()
        st = self.obs.step_begin(self.step_count)
        plan = self._plan()
        if st is not None:
            st.mark("plan")
        finished = self._run_chunks(plan.chunks)
        if st is not None:
            st.mark("chunk")
        # unchunked admission: a request admitted this step decodes this
        # step; budgeted steps decode exactly the planned rows
        rows = (self._decode_rows() if self.budget is None
                else plan.decode_rows)
        if not rows:
            if plan.chunks:
                self.step_count += 1
                self._audit_step()
            self.obs.step_end(st, n_chunks=len(plan.chunks))
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
                return self._step_speculative(st, plan, finished, rows, reqs,
                                              k_round)
        active = np.zeros((self.max_slots,), bool)
        active[rows] = True
        if self.paged:
            for r in rows:
                self.kv.ensure(r, self.kv.length(r) + 1)
            step_state = self.kv.view(self.kv.live_width(rows))
        else:
            step_state = self.kv.state
        # under the fault plane both planes read the last logits to the
        # host, to quarantine a poisoned row before sampling
        quar = self.faults is not None
        if self.offload is not None:
            # free slots bypass the expert pool: their dummy tokens never
            # touch the cache or the counters
            logits, state, self._pstate, route_ids = self._exec.decode(
                step_state, self.tokens, self._pstate, active,
                obs=self._phases)
            self.usage.update(route_ids, rows=rows)
            nxt_dev = logits[:, -1]
        elif quar:
            logits, state, _, infos = self._exec.decode(
                step_state, self.tokens, active=active,
                collect_info=self._collect, obs=self._phases)
            nxt_dev = logits[:, -1]
        else:
            out = self._exec.decode_sampled(
                step_state, self.tokens, collect_info=self._collect,
                greedy=self._greedy, active=active, obs=self._phases)
            nxt_dev, state = out[0], out[1]
            infos = out[2] if self._collect else None
        if self._collect and self.offload is None:
            ids, _ = routing_from_info(self.cfg, infos, want_hiddens=False)
            self.usage.update(ids, rows=rows)
        if st is not None:
            st.mark("dispatch")
        if self.paged:
            self.kv.adopt(state)
            for r in rows:
                self.kv.note_tokens(r, self.kv.length(r) + 1)
        else:
            self.kv.state = state
        if quar:
            # (max_slots, V) to the host every step: the price of
            # inspecting the logits before sampling
            last = nxt_dev.float().cpu().numpy()
            if st is not None:
                st.mark("sync")
            reqs = self._quarantine(last, reqs, finished)
            nxt = np.zeros((self.max_slots,), np.int32)
            if reqs:
                srows = [r.slot for r in reqs]
                if self._greedy:
                    nxt[srows] = np.argmax(last[srows], axis=-1)
                else:
                    nxt[srows] = self._sample_rows(
                        torch.as_tensor(last[srows], device=self.device),
                        reqs)
                    if st is not None:
                        st.mark("sample")
        elif self._greedy:
            # the step's one blocking read: the device's work lands here
            nxt = (nxt_dev.cpu().numpy() if self.offload is None
                   else self._sample_rows(nxt_dev, reqs))  # every slot's row
            if st is not None:
                st.mark("sync")
        else:
            nxt = np.zeros((self.max_slots,), np.int32)
            nxt[rows] = self._sample_rows(nxt_dev[rows], reqs)
            if st is not None:
                st.mark("sample")
        for req in reqs:
            t = int(nxt[req.slot])
            req.emit(t)
            if self._done(req, t):
                self._finish(req, self._reason(t))
                finished.append(req)
            else:
                self.tokens[req.slot, 0] = t
        self.step_count += 1
        self._audit_step()
        self._end_step(st, plan, reqs)
        return finished

    def _end_step(self, st, plan: StepPlan, reqs: List[GenRequest]) -> None:
        """Close a timed step: its ``host`` phase, and the live context of
        its decode rows from the host's request records (no device read)
        for the roofline."""
        if st is None:
            return
        st.mark("host")
        ctx = (sum(len(r.prompt) + len(r.generated) for r in reqs)
               / max(1, len(reqs)))
        self.obs.step_end(st, n_decode=len(reqs), n_chunks=len(plan.chunks),
                          context_len=ctx)

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

    def _step_speculative(self, st, plan: StepPlan,
                          finished: List[GenRequest], rows: List[int],
                          reqs: List[GenRequest], k_round: int
                          ) -> List[GenRequest]:
        """One draft-and-verify round over the running rows: the draft
        proposes ``k_round`` tokens per row, the target verifies every
        row's in one C = k_round + 1 chunk (on the packed plane one pool
        acquire per MoE layer over the B * C token rows), each row emits
        its longest matching prefix plus the target's own next token, and
        the target's KV (``truncate``: a position reset on dense rings,
        the table trim on pages) and the draft's bookkeeping roll back
        past each row's rejection point.  On a stack with recurrent layers
        (dense slots only) each row's state is snapshotted before the
        round, restored after it and stepped through the accepted tokens
        one at a time."""
        C = k_round + 1
        for req in reqs:
            if self._draft_rid[req.slot] != req.rid:
                self._draft_admit(req)
        props = self._draft_propose(reqs, k_round)
        # a verify chunk folds rejected tokens into the recurrent carries,
        # which no position reset undoes: snapshot each row's state now,
        # restore it and replay the accepted tokens after the verdict
        snaps = ({req.slot: self.kv.snapshot(req.slot) for req in reqs}
                 if self._has_rec else {})
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
                step_state, chunk, self._pstate, active, obs=self._phases)
            self.usage.update(route_ids, rows=tok_rows)
        else:
            logits, state, _, infos = self._exec.decode(
                step_state, chunk, active=active, collect_info=self._collect,
                obs=self._phases)
            if self._collect:
                ids, _ = routing_from_info(self.cfg, infos,
                                           want_hiddens=False)
                self.usage.update(ids, rows=tok_rows)
        if st is not None:
            st.mark("dispatch")
        if self.paged:
            self.kv.adopt(state)
            for r in rows:
                self.kv.note_tokens(r, base_len[r] + C)
        else:
            self.kv.state = state
        # the round's one blocking read: every row's target argmax
        tgt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        if st is not None:
            st.mark("sync")
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
                if self._has_rec:
                    # one token at a time: C = 1 steps are plain decode's
                    # own, so the carries (and the rings riding along) land
                    # where non-speculative decode would leave them
                    snap = snaps[r]
                    for j in range(len(emitted)):
                        _, snap, _, _ = self._exec.decode(
                            snap, chunk[r: r + 1, j: j + 1])
                    self.kv.restore(snap, r)
                else:
                    self.kv.truncate(
                        r, len(req.prompt) + len(req.generated) - 1)
                self._draft_consumed[r] += min(a, k_round - 1)
        if self.offload is not None:
            total = (int(self._pstate.counts[2]) + int(self._pstate.counts[3])
                     ) * self.offload.expert_bytes
            self.spec_metrics.add_bytes(total - self._spec_last_h2d)
            self._spec_last_h2d = total
        self.step_count += 1
        self._audit_step()
        self._end_step(st, plan, reqs)
        return finished

    def run(self, max_steps: Optional[int] = None) -> List[GenRequest]:
        """Drive until every submitted request finishes; returns them in
        completion order."""
        steps = 0
        while self.sched.has_waiting or self.sched.n_running or self._swapped:
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

    def _prefix_metrics(self) -> Dict[str, float]:
        out = {"lookups": self._prefix.lookups,
               "hit_tokens": self._prefix_hit_tokens,
               "prefills_skipped": self._prefills_skipped}
        out.update(self._prefix.stats())
        return out

    def _kv_host_metrics(self) -> Dict[str, float]:
        out = dict(self.kv.host_stats())
        out.update(preemptions=self.sched.preemptions,
                   resumes=self.sched.resumes,
                   recomputes=self._recomputes,
                   swapped_now=len(self._swapped))
        return out

    def _faults_metrics(self) -> Dict[str, float]:
        """Injector fire counts (zeros without an injector), the fetch
        ladder's counters, NaN quarantines, and the terminal statuses of
        every request this engine has seen."""
        out = {"enabled": int(self.faults is not None), "injected": 0}
        for s in FAULT_SITES:
            out[f"fired_{s}"] = 0
        if self.faults is not None:
            out.update(self.faults.stats())
        out.update(self._exec.fault_counters)
        out["nan_quarantined"] = self._nan_quarantined
        counts = {"completed": 0, "cancelled": 0, "deadline_exceeded": 0,
                  "failed": 0}
        for r in self.sched.finished:
            counts[r.status] += 1
        counts["rejected"] = self.sched.queue_rejected
        out.update(counts)
        return out

    def metrics(self) -> Dict[str, Dict[str, object]]:
        """The namespaced telemetry snapshot ``{namespace: {key: value}}``
        (``obs.schema``): the collectors read fresh state now; the timing
        and roofline namespaces appear when enabled."""
        return self.obs.snapshot()

    def stats(self) -> Dict[str, float]:
        """The reference's flat view, a projection of :meth:`metrics`
        (``obs.flatten_legacy``: engine counters bare, ``kv_*``,
        ``offload_*``, every other namespace ``<ns>_<key>``)."""
        return self.obs.legacy_flat()
