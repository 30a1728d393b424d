"""Registry-drift fixture: config keys and metric names the registry does
not know.

The fixture tests read ``SERVICE_KEYS`` here as the ``service`` block's
tuple and run against an injected registry of ``{"service.known"}`` /
``{"known.metric", "family.*"}``.
"""
from reporter_tpu_torch.utils import metrics

SERVICE_KEYS = ("known",
                "not_registered")  # KN001: a key the registry lacks


def emit_unknown_metric(code):
    metrics.count("known.metric")
    metrics.count(f"family.{code}")
    metrics.count("rogue.metric")  # MT001: unregistered literal
    with metrics.timer(f"other.family.{code}"):  # MT001: unregistered f-string family
        pass
