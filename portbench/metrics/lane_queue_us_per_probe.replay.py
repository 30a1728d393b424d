"""The chunks' waits in the device lanes' queues, microseconds a probe:
from a chunk's submit to the dispatch lane taking it up, plus from its
dispatch's end to the drain lane taking it up (the program's
``matcher.lane.dispatch_queued`` and ``matcher.lane.drain_queued``
timers, summed over chunks: waits of chunks in flight together
overlap)."""
from ._timers import us_per_probe


def read(obs):
    return us_per_probe(obs, "matcher.lane.dispatch_queued",
                        "matcher.lane.drain_queued")
