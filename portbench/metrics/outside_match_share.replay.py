"""The share of the replay window spent outside ``match_many``: parsing
shard files, cutting windows, ``report()``, tile rows and their writes
(the timing proxy's seconds against the window's)."""


def read(obs):
    inside = obs.spans.get("match_many")
    if inside is None or obs.window_s <= 0:
        return None
    return 100.0 * (1.0 - inside / obs.window_s)
