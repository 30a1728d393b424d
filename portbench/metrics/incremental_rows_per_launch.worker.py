"""Rows a launch of the incremental step, the window's mean (the program's
``match.incremental.rows.launched`` over ``match.incremental.launches``):
the requests of a flush's parameter group that one launch carries."""


def read(obs):
    launches = obs.counters.get("match.incremental.launches")
    if not launches:
        return None
    return obs.counters.get("match.incremental.rows.launched", 0) / launches
