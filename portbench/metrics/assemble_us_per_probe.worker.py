"""The incremental decode's assembly of the matches from the committed
paths, wall microseconds a message consumed (the program's
``match.incremental.assemble`` timer, once a call)."""
from ._timers import us_per_probe


def read(obs):
    return us_per_probe(obs, "match.incremental.assemble")
