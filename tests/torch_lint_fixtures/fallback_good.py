"""Failure-domain fixture: every breaker's domain has a pair (a host
fallback and a card domain that raises)."""
from reporter_tpu_torch.utils.circuit import CircuitBreaker

covered = CircuitBreaker("covered.circuit", threshold=3, cooldown_s=1.0)
card = CircuitBreaker("card.circuit", threshold=3, cooldown_s=1.0)
