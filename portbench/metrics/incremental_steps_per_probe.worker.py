"""Real steps the incremental decode ran a message consumed (the program's
``match.incremental.steps`` over the window's messages): 1 when each
message is decoded once; above 1 by the points that requests which reset
their carried state replay."""


def read(obs):
    kept = obs.counters.get("match.incremental.steps")
    if not kept or obs.work <= 0:
        return None
    return kept / obs.work
