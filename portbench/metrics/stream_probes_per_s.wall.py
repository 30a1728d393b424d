"""The stream window's messages consumed over its wall seconds: the rate at
which the worker catches up on a partition's backlog, read per layer
because the host's speed moves it from run to run by more than any bound
could hold (``PERF.md`` §2)."""


def read(obs):
    if obs.work <= 0 or obs.window_s <= 0:
        return None
    return obs.work / obs.window_s
