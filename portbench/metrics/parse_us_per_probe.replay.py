"""The match stage's parse of its shard files, wall microseconds a probe:
reading each shard into per-uuid columns and cutting the window parts
(the program's ``pipeline.match.parse`` timer, once a shard, over the
window)."""
from ._timers import us_per_probe


def read(obs):
    return us_per_probe(obs, "pipeline.match.parse")
