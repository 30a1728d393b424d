"""Host bytes handed to the card for the incremental step, a message
consumed (the program's ``match.incremental.upload.bytes`` counter over
the window: every operand of every launch, padding included)."""


def read(obs):
    n = obs.counters.get("match.incremental.upload.bytes")
    if n is None or obs.work <= 0:
        return None
    return n / obs.work
