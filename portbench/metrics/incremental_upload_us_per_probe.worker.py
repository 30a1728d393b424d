"""The incremental step's operands copied to the card, wall microseconds a
message consumed (the program's ``match.incremental.upload`` timer, once a
launch)."""
from ._timers import us_per_probe


def read(obs):
    return us_per_probe(obs, "match.incremental.upload")
