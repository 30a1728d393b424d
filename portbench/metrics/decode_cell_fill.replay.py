"""The decode launches' fill: kept point cells over the B x T cells of
the batches handed to the lanes, padding rows and tails included (the
program's ``decode.cells.kept`` and ``decode.cells.launched``
counters over the window)."""


def read(obs):
    launched = obs.counters.get("decode.cells.launched")
    if not launched:
        return None
    return 100.0 * obs.counters.get("decode.cells.kept", 0) / launched
