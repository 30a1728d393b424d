"""The incremental decode's host prep, wall microseconds a message consumed
(the program's ``match.incremental.prep`` timer: each call's state
lookups and the appended points' candidates and routes)."""
from ._timers import us_per_probe


def read(obs):
    return us_per_probe(obs, "match.incremental.prep")
