"""The caller's wait on the drain lane at the end of each ``match_many``,
after its last chunk was prepared, wall microseconds a probe (the
program's ``matcher.join`` timer)."""
from ._timers import us_per_probe


def read(obs):
    return us_per_probe(obs, "matcher.join")
