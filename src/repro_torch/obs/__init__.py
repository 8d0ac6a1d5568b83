"""Speculation accounting (port of ``SpecMetrics`` of the reference's
``obs/__init__.py``).

Only this class is ported: the metrics registry, its schema and the
tracing plane are ROADMAP queue 1 item 7.  The reference keeps the same
totals and exports the per-round counts as histograms; the port keeps
the per-round counts as lists.
"""
from __future__ import annotations

from typing import List


class SpecMetrics:
    """Draft-and-verify accounting shared by both engines: ``rounds``,
    the per-round ``proposed``/``accepted`` counts, their totals, the
    tokens the verify chunks emitted (``accepted + 1`` per round) and the
    h2d bytes folded in by :meth:`add_bytes`."""

    def __init__(self):
        self.rounds = 0
        self.proposed: List[int] = []
        self.accepted: List[int] = []
        self.proposed_total = 0
        self.accepted_total = 0
        self.emitted_total = 0
        self.bytes_total = 0.0

    def round(self, proposed: int, accepted: int) -> None:
        """One verify round: ``proposed`` = the draft tokens offered,
        ``accepted`` = the length of the matching prefix."""
        self.rounds += 1
        self.proposed.append(int(proposed))
        self.accepted.append(int(accepted))
        self.proposed_total += int(proposed)
        self.accepted_total += int(accepted)
        self.emitted_total += int(accepted) + 1

    def add_bytes(self, bytes_h2d: float) -> None:
        """Fold measured h2d bytes into the per-emitted-token figure."""
        self.bytes_total += float(bytes_h2d)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted_total / max(1, self.proposed_total)

    @property
    def bytes_h2d_per_accepted(self) -> float:
        """h2d bytes per token the verify chunks emitted (0.0 with no
        offloaded experts)."""
        return self.bytes_total / max(1, self.emitted_total)
