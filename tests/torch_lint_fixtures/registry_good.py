"""Registry-drift fixture: every key and metric name registered."""
from reporter_tpu_torch.utils import metrics

SERVICE_KEYS = ("known",)


def emit_known_metrics(code):
    metrics.count("known.metric")
    metrics.count(f"family.{code}")
    with metrics.timer("known.metric"):
        pass
