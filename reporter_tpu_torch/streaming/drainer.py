"""Automated dead-letter replay: the spools drain themselves.

The port of ``reporter_tpu/streaming/drainer.py``. Failed tile egress
spools CSV bodies to ``.deadletter`` in the flush layout, an exhausted
submit budget spools trace request JSON to ``.traces``; a
:class:`DeadLetterDrainer` owned by the streaming worker
re-submits spooled traces through the SAME submit path the live stream
uses (responses forward into the anonymiser, so no observation is lost)
and re-egresses spooled tiles through the SAME sink (deterministic
epoch-named files, so a replay can only overwrite, never duplicate).

Discipline:

- **Paced, on the worker thread.** ``maybe_drain`` rides punctuation
  (the worker's ``replay_interval_s``; 0, the default, disables), the
  same single-threaded pacing the heartbeat uses: the anonymiser and
  batcher have no locks, so the drainer must never touch them from a
  second thread.
- **Capped exponential backoff per entry.** A failed replay backs its
  entry off ``base * 2^attempts`` seconds (capped), so a still-down
  sink is probed, not hammered.
- **Poison quarantine.** An entry still failing after
  ``max_attempts`` attempts (the worker's ``replay_attempts``, 5) moves
  to a ``.quarantine``
  subdir (dot-prefixed — every scanner skips it) for manual autopsy:
  one poison body must not wedge the drain behind it forever.
- **Trace replay is at-least-once.** Tile replay is exactly-once (the
  deterministic epoch name dedupes the sink); a replayed TRACE's segments re-enter the live pipeline as
  fresh observations, so a crash in the window between forwarding them
  and unlinking the spool entry replays the trace again on restart
  under a new flush epoch — a duplicate, not a loss. Unlinking first
  would flip that to silent loss on the mirror-image crash; duplicates
  were chosen because they are at least visible. The window is one
  entry wide and only open while a drain pass is mid-flight.

The JAX package's datastore replay (``datastore=``) comes with the
port's datastore.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import random
import time
from typing import Callable, Dict, List, Optional

from ..utils import faults, metrics, spool

logger = logging.getLogger("reporter_tpu_torch.streaming")

QUARANTINE = ".quarantine"


class DeadLetterDrainer:
    """Drains a tile spool (flush-layout CSV bodies) and its nested
    ``.traces`` spool (/report-ready request JSON) back into the
    pipeline.

    ``submit`` is the worker's match round trip (request dict ->
    response dict or None); ``forward`` receives the replayed
    responses' (key, Segment) pairs (the anonymiser hook) — without it
    a successful re-submit still clears the spool entry but the
    segments go nowhere, which is only correct for the standalone CLI
    posting to a REMOTE service that owns its own pipeline. ``sink`` is
    the TileSink failed tiles re-egress through.
    """

    #: the worker's defaults: paced passes off, five attempts an entry
    DEFAULT_INTERVAL_S = 0.0
    DEFAULT_ATTEMPTS = 5

    def __init__(self, tile_root: Optional[str],
                 trace_root: Optional[str] = None,
                 submit: Optional[Callable[[dict], Optional[dict]]] = None,
                 forward: Optional[Callable] = None,
                 sink=None,
                 interval_s: float = 30.0,
                 max_attempts: int = 5,
                 base_backoff_s: float = 1.0,
                 max_backoff_s: float = 60.0,
                 backoff_jitter: float = 0.25,
                 jitter_seed: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.tile_root = tile_root
        if trace_root is None and tile_root:
            trace_root = os.path.join(tile_root, ".traces")
        self.trace_root = trace_root
        self.submit = submit
        self.forward = forward
        self.sink = sink
        self.interval_s = interval_s
        self.max_attempts = max(1, int(max_attempts))
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        # seeded jitter on the capped exponential backoff: a fleet of
        # workers recovering from ONE outage all hit the same capped
        # schedule, so without jitter every re-submit lands in
        # thundering-herd lockstep against the sink that just came
        # back. Each entry's delay stretches by a uniform draw in
        # [0, backoff_jitter]; the RNG seeds from the pid by default
        # (distinct per fleet member) and from ``jitter_seed`` in tests
        # — the whole schedule is then deterministic by seed.
        self.backoff_jitter = max(0.0, float(backoff_jitter))
        self._jitter_rng = random.Random(
            os.getpid() if jitter_seed is None else jitter_seed)
        self.clock = clock
        self._next_pass = clock()
        # budget key -> consecutive failed attempts; entries leave the
        # table on success or quarantine, and keys with no live file
        # are pruned each pass. Keyed by _budget_key, NOT path: a
        # poison body the matcher re-quarantines under a fresh counter
        # name must share its predecessor's budget, or it cycles
        # through new names forever without ever reaching .quarantine
        self._attempts: Dict[str, int] = {}
        self._due: Dict[str, float] = {}
        # worker-shutdown latch: a paused drainer's maybe_drain is a
        # no-op, so nothing can re-enter the submit path or the sink
        # after the worker's final flush released them (the shutdown
        # order of StreamWorker.drain)
        self._paused = False

    def pause(self) -> None:
        """Stop paced drains (worker shutdown): after the final
        drain_now, no maybe_drain may touch the submit path or sink
        again — their handles are about to be released."""
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    # -- spool walks -------------------------------------------------------
    # both walks share spool.walk_files — the one definition of "what
    # counts as a spool entry" (dot/tmp files and nested spools like
    # .quarantine excluded), so the drainer can never replay something
    # the cap/backlog layer doesn't count, or vice versa
    def _trace_entries(self, cap: Optional[int] = None) -> List[str]:
        return self._entries(self.trace_root, cap)

    def _tile_entries(self, cap: Optional[int] = None) -> List[str]:
        return self._entries(self.tile_root, cap)

    @staticmethod
    def _entries(root: Optional[str], cap: Optional[int]) -> List[str]:
        """``cap`` bounds the directory walk itself (paced passes run
        on the stream thread — a 200k-entry outage backlog must not
        cost a full os.walk+stat sweep per interval); the un-walked
        tail is simply later passes' work."""
        if not root or not os.path.isdir(root):
            return []
        paths = (p for p, _sz, _mt in spool.walk_files(root, True))
        if cap is not None:
            paths = itertools.islice(paths, cap)
        return sorted(paths)

    def backlog(self) -> Dict[str, int]:
        """{"tiles": n, "traces": n} — what is left to drain."""
        return {"tiles": len(self._tile_entries()),
                "traces": len(self._trace_entries())}

    # -- replay ------------------------------------------------------------
    def _budget_key(self, root: Optional[str], path: str) -> str:
        """Stable attempt-budget identity for a spool entry. Trace
        bodies are named ``{prefix}.{uuid}.json`` by the batcher AND by
        the matcher's poison quarantine (uuids are caller-supplied and
        may themselves contain dots, so take everything between the
        FIRST dot and the ``.json`` suffix — never a rightmost-token
        parse that would collapse distinct dotted uuids onto one
        budget), so a body that gets re-spooled under a fresh name
        during its own replay keeps burning the same budget. Tile names
        are already deterministic — the path is the identity."""
        if root == self.trace_root:
            name = os.path.basename(path)
            if name.endswith(".json") and "." in name[:-5]:
                return "uuid:" + name[:-5].split(".", 1)[1]
        return path

    def _replay_trace(self, path: str) -> bool:
        if self.submit is None:
            return False
        with open(path, encoding="utf-8") as f:
            body = json.load(f)
        # the same failure domain the live submit path runs under: a
        # chaos scenario arming matcher.submit holds replays down too
        faults.failpoint("matcher.submit")
        # a deterministically-poisoned body makes the IN-PROCESS matcher
        # re-quarantine it (a fresh spool entry) while returning a
        # well-formed empty match — without this delta check that reads
        # as success, the old entry unlinks, and the poison cycles
        # spool->replay->spool forever. Counting it as a failure sends
        # it down the normal backoff -> .quarantine road. (Concurrent
        # live-traffic quarantines can trip this too; that mis-scores
        # one attempt, not the entry — it just backs off and retries.)
        q0 = metrics.default.counter("matcher.assemble.quarantined")
        response = self.submit(body)
        if response is None:
            return False
        if metrics.default.counter("matcher.assemble.quarantined") > q0:
            return False
        if self.forward is not None:
            from .batcher import segments_from_response
            for key, seg in segments_from_response(response):
                self.forward(key, seg)
        return True

    def _replay_tile(self, path: str) -> bool:
        if self.sink is None:
            return False
        rel = os.path.relpath(path, self.tile_root)
        tile_name, file_name = os.path.split(rel)
        tile_name = tile_name.replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            payload = f.read()
        # a failed store re-spools the body under the SAME deterministic
        # name (an overwrite) and returns False — the entry just stays
        return self.sink.store(tile_name, file_name, payload)

    def _quarantine(self, root: str, path: str) -> None:
        rel = os.path.relpath(path, root)
        dest = os.path.join(root, QUARANTINE, rel)
        try:
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            os.replace(path, dest)
            metrics.count("replay.quarantined")
            logger.error("dead-letter entry still failing after %d "
                         "attempts; quarantined to %s",
                         self.max_attempts, dest)
        except OSError as e:
            logger.error("could not quarantine %s: %s", path, e)

    def _drain_one(self, root: str, path: str, replay, ok_metric: str,
                   fail_metric: str, now: float,
                   ignore_backoff: bool) -> bool:
        key = self._budget_key(root, path)
        if not ignore_backoff and now < self._due.get(key, 0.0):
            return False
        try:
            ok = replay(path)
            err = None
        except Exception as e:
            ok = False
            err = e
        if ok:
            try:
                os.unlink(path)
            except OSError:
                pass
            self._attempts.pop(key, None)
            self._due.pop(key, None)
            metrics.count(ok_metric)
            return True
        metrics.count(fail_metric)
        attempts = self._attempts.get(key, 0) + 1
        if err is not None:
            logger.warning("dead-letter replay failed for %s "
                           "(attempt %d/%d): %s", path, attempts,
                           self.max_attempts, err)
        if attempts >= self.max_attempts:
            self._attempts.pop(key, None)
            self._due.pop(key, None)
            self._quarantine(root, path)
            return False
        self._attempts[key] = attempts
        backoff = min(self.base_backoff_s * (2.0 ** (attempts - 1)),
                      self.max_backoff_s)
        # jitter AFTER the cap: capped entries are exactly the ones a
        # whole recovering fleet would otherwise retry in lockstep
        backoff *= 1.0 + self.backoff_jitter * self._jitter_rng.random()
        self._due[key] = now + backoff
        return False

    #: replay attempts one paced pass may spend: maybe_drain runs on the
    #: ONE stream-processing thread, and during an outage every backlog
    #: entry comes due together (backoff caps at max_backoff_s) — an
    #: unbounded pass would stall the live stream for the whole
    #: backlog's worth of submit timeouts. The remainder waits for the
    #: next punctuation; drain_now (end of stream, nothing live to
    #: starve) is unbounded per pass.
    MAX_PER_PASS = 32
    #: spool entries one paced pass will even LIST (the walk itself is
    #: O(entries) stats on the stream thread)
    WALK_CAP = 2048

    def _pass(self, now: float, ignore_backoff: bool,
              only: Optional[set] = None,
              limit: Optional[int] = None,
              walk_cap: Optional[int] = None) -> int:
        drained = attempted = 0
        traces = self._trace_entries(walk_cap)
        tiles = self._tile_entries(walk_cap)
        # a drainer built without a submitter (tile-only CLI) must not
        # burn the trace spool's attempt budget, and vice versa
        work = []
        if self.submit is not None:
            work += [(self.trace_root, p, self._replay_trace,
                      "replay.traces.ok", "replay.traces.fail")
                     for p in traces]
        if self.sink is not None:
            work += [(self.tile_root, p, self._replay_tile,
                      "replay.tiles.ok", "replay.tiles.fail")
                     for p in tiles]
        for root, path, replay, ok_metric, fail_metric in work:
            if only is not None and path not in only:
                continue
            if limit is not None and attempted >= limit:
                break
            if not ignore_backoff \
                    and now < self._due.get(
                        self._budget_key(root, path), 0.0):
                continue  # backed off, not an attempt
            attempted += 1
            if self._drain_one(root, path, replay, ok_metric,
                               fail_metric, now, ignore_backoff):
                drained += 1
        # budget keys with no live file left (cap shed, operator unlink)
        # must not pin attempt/backoff state forever — but only prune
        # off a COMPLETE walk: a capped listing proves nothing absent
        if walk_cap is None or (len(traces) < walk_cap
                                and len(tiles) < walk_cap):
            live = {self._budget_key(self.trace_root, p) for p in traces} \
                | {self._budget_key(self.tile_root, p) for p in tiles}
            for table in (self._attempts, self._due):
                for key in [k for k in table if k not in live]:
                    table.pop(key, None)
        return drained

    def maybe_drain(self) -> int:
        """One paced drain pass (the worker punctuation hook); returns
        entries drained. Interval-gated so an idle spool costs two
        directory existence checks per punctuation, and bounded to
        MAX_PER_PASS replay attempts so a deep backlog cannot stall the
        stream thread."""
        if self._paused:
            return 0
        now = self.clock()
        if now < self._next_pass:
            return 0
        self._next_pass = now + self.interval_s
        return self._pass(now, ignore_backoff=False,
                          limit=self.MAX_PER_PASS,
                          walk_cap=self.WALK_CAP)

    def drain_now(self) -> int:
        """Drain until empty or until a full pass makes no progress
        (end-of-stream / CLI mode; per-entry backoff is ignored but the
        attempt budget and quarantine still apply, so a dead sink
        terminates instead of spinning). Bounded to the entries present
        when the drain started: anything spooled DURING it (a live
        stream's fresh dead-letters, a poison body re-quarantining
        itself mid-replay) belongs to the next drain — without the
        snapshot, a self-re-spooling entry makes this loop never
        terminate. Returns total entries drained."""
        total = 0
        initial = set(self._trace_entries()) | set(self._tile_entries())
        while True:
            got = self._pass(self.clock(), ignore_backoff=True,
                             only=initial)
            total += got
            if not got:
                return total
            left = set(self._trace_entries()) | set(self._tile_entries())
            if not (left & initial):
                return total


__all__ = ["DeadLetterDrainer", "QUARANTINE"]
