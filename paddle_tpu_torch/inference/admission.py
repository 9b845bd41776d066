"""Admission / preemption policy for the serving engine (fifo only).

Counterpart of ``paddle_tpu/inference/admission.py``.  The engine admits
in submit order and asks the policy only which running sequence to
preempt when the pool cannot grow every sequence by one token:
``fifo`` takes the youngest.  The ``slo_aware`` policy (which also
sheds and reorders the queue) is not ported yet.
"""
from __future__ import annotations

__all__ = ["FIFOPolicy", "RequestRejected", "get_policy"]


class RequestRejected(ValueError):
    """Submit-time rejection carrying a machine-readable reason code
    (``max_seq_len`` / ``pool`` / ``budget``).  A plain ``ValueError``
    to callers."""

    def __init__(self, msg: str, reason: str):
        super().__init__(msg)
        self.reason = reason


class FIFOPolicy:
    """Submit-order admission, youngest-first preemption, no shedding."""

    name = "fifo"

    def victim_index(self, running) -> int:
        """Index into ``running`` (admission order) of the preemption
        victim."""
        return -1


def get_policy(name=None) -> FIFOPolicy:
    """Resolve a policy: a policy instance passes through, ``None`` or
    ``"fifo"`` give the fifo policy."""
    if isinstance(name, FIFOPolicy):
        return name
    key = str(name or "fifo").strip().lower()
    if key == "fifo":
        return FIFOPolicy()
    if key == "slo_aware":
        raise NotImplementedError(
            "the slo_aware admission policy is not ported to "
            "paddle_tpu_torch yet (see ROADMAP.md)")
    raise ValueError(f"unknown admission policy {name!r}: expected 'fifo'")
