"""Draft models and the acceptance rule of draft-and-verify decoding
(port of the reference's ``core/draft.py``, its DESIGN.md §11).

One verify chunk of ``C = k + 1`` tokens through ``Executor.decode`` (one
pool acquire per MoE layer per chunk) serves several emitted tokens, so
each h2d expert fetch pays for more than one token.

* :func:`accept_length` / :func:`verify_round`: the acceptance rule.  The
  target's greedy argmax at chunk position ``j`` is computed from exactly
  the canonical prefix whenever every earlier draft token matched, so
  emitting ``target[:a+1]`` is non-speculative greedy decode for any
  draft: the draft sets the speed, never the output.
* :class:`DenseDraft`: a dense attention-only model (``tiny-draft``) run
  through a plain-plane ``Executor`` with its own KV ring.
* :class:`ReplayDraft`: replays a given continuation with a set miss
  rate, which pins the acceptance rate for tests and benchmarks.

Bookkeeping shared by both drafts: ``consumed`` counts the canonical
tokens the draft has folded into its state.  ``propose(tail, k)``
consumes ``tail`` (the canonical tokens emitted since the draft last saw
the stream: 1, or 2 after a fully accepted round), then proposes ``k``
greedy tokens, feeding itself the first ``k - 1``.  ``accept(a)`` keeps
``min(a, k - 1)`` of those feeds as canonical and rolls the position back
over the rest: for the dense draft a position reset, since ring entries
past the position are hidden by the attention mask and overwritten when
the real token lands there.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def accept_length(draft_tokens: Sequence[int],
                  target_tokens: Sequence[int]) -> int:
    """Longest prefix of ``draft_tokens`` matching the target's greedy
    choices; ``target_tokens[j]`` is the target's argmax at chunk position
    ``j``, its prediction for the token after draft token ``j``."""
    a = 0
    for d, t in zip(draft_tokens, target_tokens):
        if int(d) != int(t):
            break
        a += 1
    return a


def verify_round(draft_tokens: Sequence[int], target_tokens: Sequence[int]):
    """One round: ``target_tokens`` holds the k + 1 argmax rows of the
    verify chunk, ``draft_tokens`` the k proposals.  Returns ``(emitted,
    a)``: the accepted prefix plus the target's own next token, and the
    acceptance length the rollback uses."""
    a = accept_length(draft_tokens, target_tokens)
    return [int(t) for t in target_tokens[: a + 1]], a


class DenseDraft:
    """A dense draft model behind the draft contract (module docstring):
    a plain-plane ``Executor`` on ``device`` (the card unless ``"cpu"``),
    its own KV ring, rollback by a position reset."""

    kind = "dense"

    def __init__(self, params, cfg: ModelConfig, device=None):
        from repro_torch.runtime.executor import Executor
        if not cfg.attention_only_stack:
            raise ValueError(f"draft {cfg.name!r} must be a causal "
                             f"attention stack (rollback = pos reset)")
        if cfg.moe is not None:
            raise ValueError(f"draft {cfg.name!r} must be dense - an MoE "
                             f"draft would compete for the h2d bus")
        self.cfg = cfg
        self._exec = Executor(params, cfg, device=device)
        self._state = None
        self._consumed = 0
        self._n_fed = 0

    @property
    def consumed(self) -> int:
        return self._consumed

    def start(self, prompt, max_len: int) -> None:
        """Prefill the draft on the prompt (1, S) into a ring of
        ``max_len`` positions (callers pass the target's length plus k,
        so rejected self-feeds never wrap)."""
        prompt = np.asarray(prompt).reshape(1, -1)
        _, self._state = self._exec.prefill(prompt.astype(np.int32), max_len)
        self._consumed = int(prompt.shape[1])
        self._n_fed = 0

    def _feed(self, tok) -> torch.Tensor:
        """One decode step of a token (host ints (1, 1) or the previous
        argmax on the device) -> the argmax (1, 1) on the device."""
        logits, self._state, _, _ = self._exec.decode(self._state, tok)
        return torch.argmax(logits[:, -1], dim=-1, keepdim=True).to(torch.int32)

    def propose(self, tail: Sequence[int], k: int) -> np.ndarray:
        """Consume the canonical ``tail`` (length 1 or 2), then propose k
        greedy tokens, feeding the first k - 1.  The proposals stay on the
        device until the one read at the end."""
        assert len(tail) >= 1, "tail must contain the last emitted token"
        # roll back over rejected feeds: their ring entries are masked
        # (kpos <= qpos) and get overwritten
        self._state = dict(self._state, pos=self._consumed)
        for t in tail:
            d = self._feed(np.asarray([[int(t)]], np.int32))
        self._consumed += len(tail)
        out = [d]
        for _ in range(k - 1):
            d = self._feed(d)
            out.append(d)
        self._n_fed = k - 1
        return torch.cat(out, dim=1)[0].cpu().numpy().astype(np.int64)

    def accept(self, a: int) -> None:
        """The first ``a`` proposals matched: keep ``min(a, k - 1)`` of the
        fed ones as canonical, roll the position back over the rest."""
        self._consumed += min(int(a), self._n_fed)
        self._n_fed = 0


class ReplayDraft:
    """Replays ``reference`` (prompt + the target's greedy continuation)
    as the draft: acceptance 1.0, except every ``miss_every``-th proposal
    is shifted by one to force a rejection (0 never misses).  Its
    ``consumed`` arithmetic is the dense draft's."""

    kind = "replay"

    def __init__(self, reference, *, miss_every: int = 0,
                 vocab_size: int = 512):
        self._ref = np.asarray(reference).reshape(-1).astype(np.int64)
        self.miss_every = int(miss_every)
        self.vocab_size = int(vocab_size)
        self._consumed = 0
        self._n_fed = 0
        self._n_proposed = 0

    @property
    def consumed(self) -> int:
        return self._consumed

    def start(self, prompt, max_len: int) -> None:
        prompt = np.asarray(prompt).reshape(-1)
        assert prompt.size <= self._ref.size and \
            np.array_equal(prompt, self._ref[: prompt.size]), \
            "replay reference must start with the prompt"
        self._consumed = int(prompt.size)
        self._n_fed = 0
        self._n_proposed = 0

    def propose(self, tail: Sequence[int], k: int) -> np.ndarray:
        self._consumed += len(tail)
        out: List[int] = []
        for j in range(k):
            idx = self._consumed + j
            t = int(self._ref[idx]) if idx < self._ref.size else 0
            self._n_proposed += 1
            if self.miss_every and self._n_proposed % self.miss_every == 0:
                t = (t + 1) % self.vocab_size
            out.append(t)
        self._n_fed = k - 1
        return np.asarray(out, np.int64)

    def accept(self, a: int) -> None:
        self._consumed += min(int(a), self._n_fed)
        self._n_fed = 0


def make_draft(name: Optional[str], seed: int = 0, device=None):
    """A :class:`DenseDraft` of the registered config ``name`` with random
    weights from ``seed`` (output never depends on the draft's quality),
    or None for no name."""
    if name is None:
        return None
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    cfg = get_config(name)
    return DenseDraft(init_model(cfg, seed=seed, device=device), cfg,
                      device=device)
