"""The match stage's reports, wall microseconds a probe: ``report()``,
the seam dedupe and the tile rows of each batch's matches (the
program's ``pipeline.match.report`` timer, once a batch)."""
from ._timers import us_per_probe


def read(obs):
    return us_per_probe(obs, "pipeline.match.report")
