"""Measured-vs-predicted roofline accounting (port of the reference's
``obs/roofline.py``, over the port's ``core/cost_model``).

Per window of engine steps the accountant compares

* **measured** decode tokens/s (host wall clock over the window, decode
  emissions only; prefill-chunk tokens are admission work) against
  ``cost_model.tokens_per_second(...)`` driven by the same window's
  measured cache statistics: ``roofline.delta_ratio`` = measured /
  predicted;
* **measured** h2d bytes/token against the *naive-offloading* traffic
  (every expert of every MoE layer per token):
  ``roofline.h2d_savings_ratio``.

The port's cost model has one hardware row, ``"h100"`` (measured on the
card, ``cost_model.HARDWARE``); the reference's rows (t4, 3060, 3080m,
a100) are refused by name: the port holds no constants for cards it
has not measured.

Hot-path discipline: the per-step feed is two integer adds.  Transfer
counters are read only at window boundaries; in the port they are the
pool state's host-side ``counts`` array (the LRU state machine runs on
the host), so the read is no device synchronisation at all.
``rec_state_bytes_per_token`` is the recurrent state read and written
once per decode token (``cost_model.recurrent_state_bytes``, 0 on an
attention-only stack); ``enc_kv_read_bytes_per_token`` is the encoder
K/V a decode token's cross-attention reads (``kv_read_bytes_per_token``
at context 0: 0 without an encoder).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from repro_torch.core import cost_model

# the reference's hardware rows, which the port refuses by name
REFERENCE_ROWS = ("t4", "3060", "3080m", "a100")


def hardware(name: str) -> cost_model.Hardware:
    """The cost model's row ``name``; a row the port has not measured is
    refused with the reason."""
    if name not in cost_model.HARDWARE:
        raise ValueError(
            f"roofline hardware {name!r}: the port's cost model has only "
            f"{sorted(cost_model.HARDWARE)} (measured on the card); the "
            f"reference's rows {list(REFERENCE_ROWS)} are not ported, for "
            f"their constants were never measured on this port")
    return cost_model.HARDWARE[name]


class RooflineAccountant:
    """Windowed measured-vs-predicted accounting over one engine.

    ``h2d_counts_fn`` returns cumulative ``(hits, spec_hits,
    demand_loads, spec_loads)``; ``None`` for engines with no expert
    streaming (the prediction then carries zero transfer terms and the
    h2d fields stay 0).
    """

    def __init__(self, registry, cfg, *, hw: str = "h100",
                 window: int = 32, expert_bits: int = 16,
                 attn_bits: int = 16, expert_bytes: float = 0.0,
                 h2d_counts_fn: Optional[Callable[[], Tuple[int, int, int,
                                                            int]]] = None):
        self.cfg = cfg
        self.hw = hardware(hw)
        self.window = max(1, int(window))
        self.expert_bits = expert_bits
        self.attn_bits = attn_bits
        self.expert_bytes = expert_bytes
        self._counts_fn = h2d_counts_fn
        self._last_counts = (0, 0, 0, 0)
        self._tokens = 0
        self._wall_ns = 0
        self._steps = 0
        self._ctx_sum = 0.0
        # cumulative (never windowed) prefix-reuse/preemption traffic:
        # fed by the engine's swap/hit paths, reported
        # at flush normalized by cumulative decode tokens
        self._swap_bytes = 0
        self._hit_tokens = 0
        self._tokens_cum = 0
        g = registry.gauge
        self._g = {k: g("roofline", k) for k in
                   ("hw", "windows", "window_steps", "measured_tok_s",
                    "predicted_tok_s", "delta_ratio",
                    "measured_h2d_bytes_per_token",
                    "naive_h2d_bytes_per_token", "h2d_savings_ratio",
                    "context_len", "rec_state_bytes_per_token",
                    "enc_kv_read_bytes_per_token",
                    "kv_swap_bytes_per_token", "prefix_hit_tokens")}
        self._g["hw"].set(hw)
        self._g["window_steps"].set(self.window)
        self._g["windows"].set(0)
        # per-layer-kind state-plane traffic: the recurrent carries (read
        # and written; 0 on an attention-only stack) and the encoder-KV
        # cross-read (0 without an encoder)
        self._g["rec_state_bytes_per_token"].set(
            2.0 * cost_model.recurrent_state_bytes(cfg))
        self._g["enc_kv_read_bytes_per_token"].set(
            cost_model.kv_read_bytes_per_token(cfg, 0.0))
        for k in ("measured_tok_s", "predicted_tok_s", "delta_ratio",
                  "measured_h2d_bytes_per_token",
                  "naive_h2d_bytes_per_token", "h2d_savings_ratio",
                  "context_len", "kv_swap_bytes_per_token",
                  "prefix_hit_tokens"):
            self._g[k].set(0.0)
        self._windows = 0

    # ------------------------------------------------------------------
    # prefix-reuse + preemption traffic, cumulative
    def add_swap_bytes(self, nbytes: int) -> None:
        """One KV swap-out or swap-in staging transfer."""
        self._swap_bytes += int(nbytes)

    def add_prefix_hit(self, n_tokens: int) -> None:
        """Prompt tokens whose prefill a cache hit skipped."""
        self._hit_tokens += int(n_tokens)
        self._g["prefix_hit_tokens"].set(self._hit_tokens)

    # ------------------------------------------------------------------
    def step(self, n_decode_tokens: int, wall_ns: int,
             context_len: float) -> None:
        """Feed one engine step (host data only); closes a window every
        ``window`` steps."""
        self._tokens += n_decode_tokens
        self._wall_ns += wall_ns
        self._ctx_sum += context_len * n_decode_tokens
        self._steps += 1
        if self._steps >= self.window:
            self.flush()

    def flush(self) -> None:
        """Close the current window (also called at end-of-run so short
        runs still report)."""
        if not self._steps or not self._tokens or not self._wall_ns:
            self._steps = self._tokens = self._wall_ns = 0
            self._ctx_sum = 0.0
            return
        tokens, wall_s = self._tokens, self._wall_ns / 1e9
        self._tokens_cum += tokens
        self._g["kv_swap_bytes_per_token"].set(
            self._swap_bytes / max(1, self._tokens_cum))
        ctx = self._ctx_sum / max(1, tokens)
        measured = tokens / wall_s

        d_counts = (0, 0, 0, 0)
        if self._counts_fn is not None:
            now = tuple(int(c) for c in self._counts_fn())
            d_counts = tuple(n - l for n, l in
                             zip(now, self._last_counts))
            self._last_counts = now
        hits, spec_hits, demand, spec = d_counts
        ts = cost_model.TokenStats(
            demand_loads=demand / tokens, spec_loads=spec / tokens,
            hits=hits / tokens, spec_hits=spec_hits / tokens)
        predicted = cost_model.tokens_per_second(
            self.cfg, self.hw, ts, self.expert_bits, self.attn_bits,
            context_len=ctx)

        h2d_per_tok = (demand + spec) * self.expert_bytes / tokens
        naive = 0.0
        if self.cfg.moe is not None and self.expert_bytes:
            naive = (self.cfg.moe_layer_count * self.cfg.moe.num_experts
                     * self.expert_bytes)

        self._windows += 1
        self._g["windows"].set(self._windows)
        self._g["measured_tok_s"].set(measured)
        self._g["predicted_tok_s"].set(predicted)
        self._g["delta_ratio"].set(measured / max(1e-12, predicted))
        self._g["measured_h2d_bytes_per_token"].set(h2d_per_tok)
        self._g["naive_h2d_bytes_per_token"].set(naive)
        self._g["h2d_savings_ratio"].set(
            naive / h2d_per_tok if h2d_per_tok > 0 else 0.0)
        self._g["context_len"].set(ctx)
        self._steps = self._tokens = self._wall_ns = 0
        self._ctx_sum = 0.0

    # ------------------------------------------------------------------
    def add_window(self, n_tokens: int, wall_s: float, *,
                   demand_loads: int = 0, spec_loads: int = 0,
                   hits: int = 0, spec_hits: int = 0,
                   context_len: float = 0.0) -> None:
        """One-shot accounting for batch-1 generate loops (the offload
        engine feeds a whole generation as one window from the stats it
        already computed — zero extra fetches)."""
        if n_tokens <= 0 or wall_s <= 0:
            return
        self._tokens = n_tokens
        self._wall_ns = int(wall_s * 1e9)
        self._ctx_sum = context_len * n_tokens
        self._steps = self.window  # force the flush path
        if self._counts_fn is None:
            # route the caller-supplied counts through the delta logic
            self._counts_fn = lambda: (hits, spec_hits, demand_loads,
                                       spec_loads)
            self._last_counts = (0, 0, 0, 0)
            self.flush()
            self._counts_fn = None
        else:
            self.flush()
