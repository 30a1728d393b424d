"""Runtime analysis: the concurrency witness (:mod:`racecheck`) that the
lock factory in :mod:`..utils.locks` feeds when it is armed."""
