"""Failure-domain fixture: a breaker whose domain has no FALLBACK_PAIRS
entry (against injected pairs covering only ``covered.circuit`` and
``card.circuit``)."""
from reporter_tpu_torch.utils.circuit import CircuitBreaker

covered = CircuitBreaker("covered.circuit", threshold=3, cooldown_s=1.0)
card = CircuitBreaker("card.circuit", threshold=3, cooldown_s=1.0)
orphan = CircuitBreaker("orphan.circuit", threshold=3, cooldown_s=1.0)  # FB001: domain not in FALLBACK_PAIRS
