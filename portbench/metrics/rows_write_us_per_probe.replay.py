"""The match stage's tile-row file writes, wall microseconds a probe (the
program's ``pipeline.match.write`` timer, once a shard)."""
from ._timers import us_per_probe


def read(obs):
    return us_per_probe(obs, "pipeline.match.write")
