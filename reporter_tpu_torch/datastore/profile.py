"""Per-city route-memo profile: persist the hot state, restore it warm.

A freshly loaded graph pays a cold native route-pair memo: its first
request batch runs every (edge_from, edge_to) Dijkstra from scratch.
After a representative replay (``datastore profile --replay``), the
native memo's RESIDENT pairs (clock eviction keeps them biased hot, so
they are the city's top route pairs) are exported with the replay's
``rt_route_memo_stats`` counters and committed as a ``.profile`` JSON
artifact in the store root. Loading the graph later warms the memo from
the artifact BEFORE the first request: ``rt_route_memo_warm`` recomputes
each pair's node kernel with the same bounded Dijkstra the serving path
runs on a miss, so a warmed hit is bit-identical to a cold-computed one:
the pre-warm changes latency, never answers.

The artifact is dot-named like every other control file in a durable
layout (``.lease``, ``.traces`` ...): tile walkers and spool accounting
skip it by the dot rule. The port of ``reporter_tpu/datastore/profile.py``
with one difference: the JAX package seeds its device route kernel's
sweep cap from the artifact's ``route_table``; the port's relaxation
runs until a quiet sweep and takes no cap, so :func:`warm_matcher` reads
only the table's ``route_bound_m``.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Optional

import numpy as np

from ..utils import fsio, metrics

logger = logging.getLogger("reporter_tpu_torch.datastore")

PROFILE_NAME = ".profile"

#: node-kernel search bound used when re-deriving warmed entries; the
#: serving path's min_bound_m floor — a kernel proven to a SMALLER
#: bound than a later query needs would re-search anyway
WARM_BOUND_M = 500.0


def profile_path(store_root: str) -> str:
    return os.path.join(store_root, PROFILE_NAME)


def export_profile(matcher, path: str, cap: int = 1 << 16,
                   city: Optional[str] = None) -> dict:
    """Dump the matcher's resident route-memo pairs to a committed
    ``.profile`` artifact (fsio atomic — a half-written profile would
    warm garbage). Returns the artifact dict; ``pairs`` is empty when
    the matcher runs the numpy fallback (no native memo to dump)."""
    pairs = []
    stats = None
    if getattr(matcher, "runtime", None) is not None:
        ea, eb = matcher.runtime.route_memo_export(cap)
        pairs = np.stack([ea, eb], axis=1).tolist() if ea.size else []
        stats = matcher.runtime.route_memo_stats()
    # frontier-bound table: the device route kernel's observed relaxation
    # depth + chunk bound over the replay (None without device routes)
    kern = getattr(matcher, "route_kernel", None)
    route_table = kern.stats() if kern is not None else None
    art = {
        "version": 1,
        "city": city,
        "n_pairs": len(pairs),
        # the replay's memo counters: how warm the memo that produced
        # this profile actually was (an all-miss replay exports noise)
        "memo_stats": stats,
        "route_table": route_table,
        "pairs": pairs,
    }
    fsio.atomic_write_text(path, json.dumps(art, separators=(",", ":")))
    metrics.count("datastore.profile.exports")
    logger.info("exported %d route-memo pairs to %s", len(pairs), path)
    return art


def load_profile(path: str) -> Optional[dict]:
    """Parse a profile artifact; None when absent or unparseable (a
    corrupt profile costs the pre-warm, never the city load)."""
    try:
        with open(path, encoding="utf-8") as f:
            art = json.load(f)
        if not isinstance(art, dict) or art.get("version") != 1:
            raise ValueError(f"unknown profile version in {path}")
        return art
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as e:
        logger.warning("unreadable profile %s (skipping pre-warm): %s",
                       path, e)
        return None


def warm_matcher(matcher, profile: Optional[dict],
                 bound_m: float = WARM_BOUND_M) -> int:
    """Pre-warm a matcher's native route memo from a profile artifact;
    returns pairs warmed (0 on the numpy fallback, an empty profile, or
    a disabled memo). Out-of-range edge ids — a profile exported from a
    different graph build — are skipped inside the native call."""
    if profile is None:
        return 0
    # the artifact's frontier-bound table: warmed host kernels prove
    # themselves to the observed serving bound, not just the floor — a
    # kernel proven to a smaller bound than a query needs re-searches
    # anyway (a malformed table costs only that). No sweep cap is seeded:
    # the device relaxation runs to a quiet sweep.
    table = profile.get("route_table")
    if isinstance(table, dict):
        try:
            bound_m = max(bound_m, float(table.get("route_bound_m") or 0))
        except (TypeError, ValueError) as e:
            logger.warning("malformed profile route_table (ignored): %s", e)
    if getattr(matcher, "runtime", None) is None:
        return 0
    pairs = profile.get("pairs") or []
    if not pairs:
        return 0
    # a structurally broken artifact (ragged/non-pair rows) must cost
    # the pre-warm, never the city load — same contract as a corrupt
    # file in load_profile
    try:
        arr = np.asarray(pairs, dtype=np.int64)
        if arr.ndim != 2 or arr.shape[1] != 2:
            raise ValueError(f"pairs must be (n, 2), got {arr.shape}")
        warmed = matcher.runtime.route_memo_warm(arr[:, 0], arr[:, 1],
                                                 bound_m=bound_m)
    except Exception as e:
        logger.warning("malformed profile pairs (skipping pre-warm): %s",
                       e)
        return 0
    metrics.count("datastore.profile.warmed_pairs", warmed)
    return warmed


__all__ = ["export_profile", "load_profile", "warm_matcher",
           "profile_path", "PROFILE_NAME", "WARM_BOUND_M"]
