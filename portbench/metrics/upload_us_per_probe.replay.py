"""The dispatch lane's host-to-device uploads of each batch, wall
microseconds a probe (the program's ``matcher.upload`` timer, inside
``matcher.decode_dispatch``)."""
from ._timers import us_per_probe


def read(obs):
    return us_per_probe(obs, "matcher.upload")
