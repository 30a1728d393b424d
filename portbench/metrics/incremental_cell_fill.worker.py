"""The incremental step's launches' fill: real steps over the R x N cells
of every launch, padded rounds included (the program's
``match.incremental.cells.kept`` and ``.cells.launched`` counters over
the window)."""


def read(obs):
    launched = obs.counters.get("match.incremental.cells.launched")
    if not launched:
        return None
    return 100.0 * obs.counters.get("match.incremental.cells.kept", 0) \
        / launched
