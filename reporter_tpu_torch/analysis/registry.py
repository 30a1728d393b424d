"""The port's cross-layer contract registry: the single source of truth.

The lint passes (``registry_drift``, ``fault_coverage``, ``durability``,
``fallback``) hold both sides of each list below against the code: a
name the code uses that is missing here fails lint, and an entry here
that nothing uses fails lint too, so the lists can neither rot nor
bloat. The JAX package's registry lists environment knobs; the port reads
no environment variable, so its operator surface is the config file's
keys (``CONFIG_KEYS``).

Adding a config key, metric or fault site is a three-line change: the
code, this registry and, for a config key, the README's key table;
``python -m reporter_tpu_torch.tools.lint --contracts-only`` names the
line that was forgotten.

Like the rest of the analysis package this imports nothing beyond the
stdlib.
"""
from __future__ import annotations

from typing import Dict, Tuple

# ---- config keys -----------------------------------------------------------
# Every key the config file's blocks accept, as "<block>.<key>": the
# service block's (service/server.py SERVICE_KEYS, MATCHER_KEYS,
# SERVER_KEYS, OBS_KEYS, FAULT_KEYS, CITY_KEYS), the worker block's
# (streaming/worker.py WORKER_KEYS), the pipeline block's
# (pipeline/simple_reporter.py PIPELINE_KEYS) and the datastore object's
# (datastore/__init__.py DATASTORE_KEYS). Two-sided with those tuples
# (registry_drift KN001) and with README's key table (KN002).
CONFIG_KEYS: Dict[str, str] = {
    "service.threshold_sec": "report privacy threshold (s)",
    "service.max_batch": "dispatcher batch cap, traces",
    "service.max_wait_ms": "dispatcher flush deadline",
    "service.idle_grace_ms": "dispatcher idle flush window",
    "service.queue_max": "dispatcher queue bound, traces",
    "service.queue_policy": "full-queue shed policy: reject|oldest",
    "service.latency_budget_ms": "per-batch latency budget (0 = fixed)",
    "service.admission": "SLO-driven admission gate on /report",
    "service.inflight_max": "admitted in-flight cap (0 = derived)",
    "service.pressure_hold_s": "degradation-ladder hysteresis dwell",
    "service.native": "C++ host runtime prep/assembly/writer on/off",
    "service.pipeline": "device-lane overlap on/off",
    "service.chunk": "traces per prep call and decode launch",
    "service.prep_threads": "native prep worker-pool width",
    "service.route_device": "device route-cost kernels on/off",
    "service.prune_sigma": "candidate prune margin, sigma multiple",
    "service.incremental": "incremental matcher path on/off",
    "service.incremental_lag": "fixed-lag commit bound, kept points",
    "service.incremental_mb": "carried-state table byte budget (MB)",
    "service.decode": "decode: fused|scan|assoc",
    "service.decode_shard": "decode mesh over the cards: auto|on|off",
    "service.device_slice": "the cards of the mesh: slot/procs or lo:hi",
    "service.seq_shards": "time spans of the assoc decode's mesh",
    "service.circuit_threshold": "errors that open a breaker",
    "service.circuit_cooldown_s": "breaker cooldown before a probe",
    "service.pool_size": "handler threads per process",
    "service.trace": "request tracing on/off",
    "service.slo_ms": "per-stage p99 budgets flipping /health",
    "service.shadow_sample": "decode shadow sample fraction",
    "service.profile_events": "profiler wide-event ring capacity",
    "service.flightrec_dir": "flight-recorder dump dir",
    "service.lockcheck": "runtime lock witness on/off, raw: bare locks",
    "service.racefuzz": "schedule-fuzz spec seed[:prob][@max_us]",
    "service.faults": "deterministic failpoint spec",
    "service.deadletter_dir": "quarantined-trace spool dir",
    "service.deadletter_max_mb": "spool byte cap (oldest shed)",
    "service.city_budget_mb": "multi-city residency byte budget",
    "worker.heartbeat_s": "worker heartbeat interval (0 off)",
    "worker.retry_budget": "submit requeues before dead-letter",
    "worker.backpressure": "streaming offer backpressure on/off",
    "worker.backpressure_latency_s": "submit-EWMA slow-down threshold",
    "worker.writer_id": "writer tag in epoch tile names",
    "worker.replay_interval_s": "dead-letter drain pace (0 off)",
    "worker.replay_attempts": "replays before .quarantine",
    "worker.aws_access_key_id": "tile sink S3 credentials",
    "worker.aws_secret_access_key": "tile sink S3 credentials",
    "worker.session_gap_ms": "per-vehicle session gap",
    "worker.compact_interval_s": "background compactor pace (s)",
    "pipeline.aws_access_key_id": "archive/sink S3 credentials",
    "pipeline.aws_secret_access_key": "archive/sink S3 credentials",
    "datastore.handle_cache_size": "partition mmap-handle LRU size",
    "datastore.ledger_max": "ingest-ledger keys a partition",
    "datastore.lease_ttl_s": "cross-process writer-lease TTL (0 off)",
    "datastore.freshness": "freshness tier on/off",
    "datastore.freshness_mb": "recent-delta overlay byte budget (MB)",
    "datastore.freshness_waiters": "/feed long-poll waiter cap",
    "datastore.freshness_poll_s": "feed store-watch pace",
}

# ---- metric names ----------------------------------------------------------
# Every name the code passes to the metrics layer (utils.metrics
# count/timer/observe). Entries ending in ``*`` are prefix patterns for
# dynamically suffixed families (f-string call sites), exempt from the
# dead-entry check (MT002); exact entries must have a literal somewhere.
METRICS: Dict[str, str] = {
    # matcher
    "matcher.prep": "host prep per chunk (timer)",
    "matcher.decode_dispatch": "upload + launch + async copy (timer)",
    "matcher.decode_wait": "wait for the paths (timer)",
    "matcher.assemble": "run walk + column conversion (timer)",
    "matcher.upload": "host-to-device uploads of a batch (timer)",
    "matcher.join": "caller's wait on the drain lane's futures (timer)",
    "matcher.lane.dispatch_queued": "chunk's wait for the dispatch lane "
                                    "(timer)",
    "matcher.lane.drain_queued": "chunk's wait for the drain lane after "
                                 "its dispatch (timer)",
    "decode.upload.bytes": "host bytes uploaded for the decode",
    "decode.upload.copies": "host-to-device copies issued for the decode "
                            "(one a batch: its slab)",
    "decode.upload.restaged_bytes": "host bytes the dispatch lane copied "
                                    "into a slab because the prep had not "
                                    "written them there",
    "decode.cells.kept": "kept point cells handed to the lanes",
    "decode.cells.launched": "B x T cells of the batches handed to the "
                             "lanes",
    "matcher.circuit.*": "breaker transitions + degraded-chunk counts",
    "prep.phase.*": "native prep phase split (candidates/select/routes)",
    "route.device.*": "device route kernels: chunks/sources/refusals",
    # service
    "service.requests": "/report requests",
    "wire.native": "responses emitted by the C-level writer",
    "wire.fallback": "responses served by the Python columnar writer",
    "wire.errors": "native writer faults (Python writer serves)",
    "wire.circuit.*": "wire-writer breaker transitions/probes",
    "service.procs.spawned": "worker processes forked at startup",
    "service.procs.deaths": "worker exits outside shutdown",
    "service.procs.restarts": "workers restarted into their slot",
    "service.procs.worker_start": "per-worker post-fork service builds",
    "service.requests.histogram": "/histogram requests",
    "service.handle": "/report handling (timer)",
    "service.histogram": "/histogram handling (timer)",
    "service.errors.*": "error responses by status code",
    "dispatch.batches": "micro-batches dispatched",
    "dispatch.traces": "traces dispatched",
    "dispatch.match_many": "batched match call (timer)",
    "dispatch.errors": "dispatch loop errors",
    # load management
    "dispatch.queue.*": "bounded-queue sheds: rejected/evicted/waits",
    "admission.*": "gate verdicts: admitted + shed.{queue,slo,inflight}",
    "pressure.*": "degradation-ladder transitions + rung effects",
    "batch.latency.*": "EWMA flush model: per-trace latency + caps",
    "backpressure.*": "streaming flow control: delays + sheds",
    "slo.malformed": "malformed SLO specs ignored (fail-open, counted)",
    "decode.shadow.suppressed": "shadow chunks skipped by the ladder",
    # streaming
    "batcher.flush": "batched session flush through submit_many (timer)",
    "egress.ok": "tile egress successes",
    "egress.fail": "tile egress failures",
    "egress.deadletter": "tile bodies spooled to the dead letter",
    "batch.requeued": "failed submits requeued under budget",
    "batch.dropped": "batches dropped after budget exhaustion",
    "batch.deadletter": "trace JSON spooled for replay",
    "state.epoch_skipped": "restores that skipped a committed epoch",
    "state.save.fail": "failed state snapshots (degraded)",
    "state.epoch_commit.fail": "failed epoch-marker commits (degraded)",
    "matcher.assemble.quarantined": "poisoned traces spooled, chunk kept",
    "deadletter.shed": "spool entries shed by the byte cap (oldest)",
    "replay.quarantined": "dead-letter entries moved to .quarantine",
    # pipeline
    "pipeline.gather": "backfill stage 1 (timer)",
    "pipeline.match": "backfill stage 2 (timer)",
    "pipeline.match.parse": "a shard's parse and window cut (timer)",
    "pipeline.match.report": "a batch's report(), seam dedupe and rows "
                             "(timer)",
    "pipeline.match.write": "a shard's tile-row writes (timer)",
    "pipeline.report": "backfill stage 3 (timer)",
    "pipeline.windows": "time windows the match stage planned",
    "pipeline.chunks": "match chunks the stage planned",
    "pipeline.batches": "match_many calls of the match stage",
    "pipeline.seam_dropped": "duplicate segments dropped at window seams",
    # datastore
    "datastore.ingest.parse": "tile CSV parse (timer)",
    "datastore.ingest.bad_rows": "dropped malformed tile rows",
    "datastore.ingest.dir": "directory replay (timer)",
    "datastore.ingest.quarantined": "tiles quarantined mid-ingest",
    "datastore.ingest.files": "tile files replayed",
    "datastore.ingest.deduped": "ledger-deduped appends (exactly-once)",
    "datastore.ingest.ledger_evicted": "ledger keys aged out by the cap",
    "datastore.tee.deadletter": "tee-failed tiles spooled (sink was ok)",
    "datastore.query": "histogram query (timer)",
    "datastore.aggregate": "observation aggregation (timer)",
    "datastore.aggregate.rows": "observation rows aggregated",
    "datastore.store.append": "segment commit (timer)",
    "datastore.store.compact": "compaction pass (timer)",
    "datastore.store.auto_compactions": "pressure-policy compactions",
    "datastore.store.stale_commits": "seq-fence aborts (lease lapsed)",
    "datastore.query.cache.hits": "partition-handle LRU hits",
    "datastore.query.cache.misses": "partition-handle LRU misses",
    "datastore.query.many": "batched multi-segment query sweep (timer)",
    "datastore.query.bbox": "bbox query: resolve + batched sweep (timer)",
    "datastore.query.batched_segments": "segments served via query_many",
    "datastore.lease.*": "writer-lease acquires/renewals/steals/rejections",
    "datastore.compactor.*": "background compaction passes/compactions",
    "datastore.city.*": "city-residency LRU loads/hits/evictions",
    # map lifecycle
    "swap.flips": "hot swaps that flipped routing to the new map",
    "swap.refusals": "swaps refused (budget pin or shadow agreement)",
    "swap.shadow.*": "dual-version gate: sampled/checks/agree/mismatch",
    "datastore.epoch.*": "map-version epochs: stamped segments, pinned/"
                         "merged queries, feed epoch events",
    "datastore.profile.exports": "route-memo profile artifacts written",
    "datastore.profile.warmed_pairs": "memo pairs pre-warmed at city load",
    "tilestore.parse.native": "RGT graph tiles parsed by the C++ parser",
    # freshness tier
    "overlay.*": "recent-delta overlay: records/deduped/evicted/committed",
    "feed.*": "change feed: events/polls/delivered/shed/timeouts/watch",
    "viewport.*": "materialised viewport summaries: refreshes/queries",
    "service.requests.feed": "/feed long-poll requests",
    # observability
    "flightrec.dumps": "flight-recorder postmortems written",
    # device profiler (obs/profiler.py)
    "decode.compile.count": "decode dispatches that paid a kernel build",
    "decode.compile.recompiles": "same-shape rebuilds (storm signal)",
    "decode.compile": "kernel build seconds per episode (timer)",
    "decode.dispatch.first": "building-dispatch wall (timer)",
    "decode.dispatch.steady": "steady-state dispatch wall (timer)",
    "decode.launch.latency": "fused kernel launch latency (timer)",
    "decode.occupancy.*": "per-bucket occupancy ratio histograms",
    "decode.shadow.chunks": "chunks shadow-decoded by the plain scan",
    "decode.shadow.sampled": "traces shadow-decoded by the plain scan",
    "decode.shadow.mismatch": "shadow decodes scoring off the plain scan",
    "decode.shadow.mismatch_ratio": "per-chunk mismatch ratio (timer)",
    "decode.shadow.dropped": "shadow chunks shed (sampler backlogged)",
    "decode.shadow.errors": "shadow decode failures (chunk skipped)",
    "decode.shard.chunks": "chunks decoded sharded over a decode mesh",
    "decode.shard.rows": "rows placed across a decode mesh's data axis",
    "profile.chunks": "wide events recorded",
    # incremental matcher (matcher/incremental.py)
    "match.incremental.*": "carried-state path: steps/commits/matches/"
                           "state_bytes/evictions/fallbacks/resets/"
                           "shadow checks + the advance/decode timers",
    "match.incremental.prep": "host prep of the appended points: state "
                              "lookups, candidates, routes (timer)",
    "match.incremental.upload": "the step's operands copied to the "
                                "device (timer)",
    "match.incremental.assemble": "the matches' assembly from the "
                                  "committed paths (timer)",
    "match.incremental.launches": "incremental_steps launches",
    "match.incremental.cells.launched": "R x N cells of each launch, "
                                        "padding included",
    "match.incremental.cells.kept": "real steps among the launched cells",
    "match.incremental.rows.launched": "N rows of each launch",
    "match.incremental.upload.bytes": "bytes of the operands handed to "
                                      "each launch",
    "match.incremental.evictions.budget": "carried states evicted by the "
                                          "byte budget (LRU)",
    # runtime concurrency witness (analysis/racecheck.py)
    "racecheck.findings": "witness/audit findings, all RC rules",
    "racecheck.*": "per-rule finding counts (RC001-RC004)",
}

# ---- failpoint sites -------------------------------------------------------
# Mirrors utils/faults.py KNOWN_SITES (fault_coverage FP001 holds the two
# identical) and adds the coverage contract: every site has a
# failpoint() call site (FP002) and is armed by tests/test_torch_faults.py
# or chip_smoke.py's [faults] phase (FP003).
FAULT_SITES: Dict[str, str] = {
    "native.prep": "native prep error -> breaker + numpy prep (a "
                   "route_device matcher raises)",
    "decode.dispatch": "decode error -> breaker, the chunk raises",
    "matcher.assemble": "assembly error -> per-trace scalar + quarantine",
    "matcher.submit": "report submit failure -> bounded requeue",
    "egress.http": "tile sink failure -> dead-letter spool",
    "datastore.commit": "segment commit failure -> caller quarantine",
    "datastore.compact": "crash mid-compaction -> orphan dir, manifest "
                         "untorn; next holder re-compacts",
    "datastore.lease": "lease I/O failure -> mutation refused (spooled)",
    "state.save": "snapshot failure -> degraded (wider replay window)",
    "worker.offer": "crash at an exact stream position",
    "worker.post_egress": "crash between sink ack and epoch marker",
    "wire.native": "native wire-writer fault -> Python writer, same bytes",
    "admission.gate": "gate/sensor failure -> fail OPEN (admit), counted",
    "route.device": "device route fill error -> breaker, the chunk raises",
    "match.incremental.commit": "error at a fixed-lag commit -> carried "
                                "state dropped, batch-path replay",
    "city.swap": "error in the widest swap window (candidate loaded and "
                 "gated, old still serving) -> old map keeps serving",
}

# ---- durable layout roots --------------------------------------------------
# Modules whose writes land under durable roots (the datastore partition
# layout, the state snapshot and epoch marker, tile-sink output and the
# dead-letter spools). The durability pass (DUR001-003) holds every write
# here to the fsio commit protocol.
DURABLE_MODULES: Tuple[str, ...] = (
    "reporter_tpu_torch/datastore/store.py",
    "reporter_tpu_torch/datastore/ingest.py",
    # the per-city route-memo profile commits into the store root; the
    # .lease file is flock-serialised coordination state whose torn body
    # parses as "no holder" (datastore/lease.py), so it is not here
    "reporter_tpu_torch/datastore/profile.py",
    "reporter_tpu_torch/streaming/state.py",
    "reporter_tpu_torch/streaming/anonymiser.py",
    "reporter_tpu_torch/utils/fsio.py",
    # the flight recorder dumps into the dead-letter layout
    "reporter_tpu_torch/obs/flightrec.py",
    # the spool layer owns every dead-letter write, and the drainer moves
    # entries within the spool roots (.quarantine)
    "reporter_tpu_torch/utils/spool.py",
    "reporter_tpu_torch/streaming/drainer.py",
)

# ---- epoch-marker commit ordering (DUR004) ---------------------------------
# "relpath::qualname" -> (ack_call, commit_call): in the named function,
# every ``commit_call`` is reachable only after an ``ack_call`` (a marker
# committed before the sink acked would make a restore skip an epoch the
# sink never got).
EPOCH_COMMIT_CONTRACTS: Dict[str, Tuple[str, str]] = {
    "reporter_tpu_torch/streaming/worker.py::StreamWorker._flush_tiles":
        ("punctuate", "commit_epoch"),
}

# ---- failure domains (FB rules) --------------------------------------------
# Keyed by circuit-breaker domain: each names the fault site that
# exercises it, the config key that chooses its path, what serves when it
# fails, and the tests that pin that leg. A host domain's fallback is a
# second implementation held byte-equal to the first; a card domain's is
# "raises" (the port never degrades from the card to the CPU: the chunk
# fails, the breaker opens and refuses until a probe closes it).
FALLBACK_PAIRS: Dict[str, Dict[str, object]] = {
    "matcher.circuit": {  # native prep <-> numpy prep
        "fault_site": "native.prep",
        "knob": "service.native",
        "fallback": "numpy prep, byte-equal; raises on a route_device "
                    "matcher (its numpy prep would route on the host)",
        "parity_test": (
            "tests/test_torch_faults.py::"
            "test_native_prep_domain_degrades_as_the_jax_package",
            "tests/test_torch_faults.py::"
            "test_card_domains_refuse_and_never_degrade"),
    },
    "matcher.circuit.decode": {  # the card's decode
        "fault_site": "decode.dispatch",
        "knob": "service.decode",
        "fallback": "raises",
        "parity_test": "tests/test_torch_faults.py::"
                       "test_card_domains_refuse_and_never_degrade",
    },
    "matcher.circuit.route": {  # device route costs
        "fault_site": "route.device",
        "knob": "service.route_device",
        "fallback": "raises",
        "parity_test": "tests/test_torch_faults.py::"
                       "test_card_domains_refuse_and_never_degrade",
    },
    "matcher.circuit.assemble": {  # native batched <-> per-trace assembly
        "fault_site": "matcher.assemble",
        "knob": "service.native",
        "fallback": "per-trace numpy assembly, byte-equal; a trace that "
                    "fails alone is quarantined",
        "parity_test": "tests/test_torch_faults.py::"
                       "test_assemble_domain_quarantines_as_the_jax_package",
    },
    "wire.circuit": {  # native wire writer <-> Python columnar writer
        "fault_site": "wire.native",
        "knob": "service.native",
        "fallback": "Python writer, byte-equal",
        "parity_test": "tests/test_torch_faults.py::"
                       "test_wire_domain_degrades_as_the_jax_package",
    },
    "matcher.circuit.incremental": {  # carried state <-> windowed batch
        "fault_site": "match.incremental.commit",
        "knob": "service.incremental",
        "fallback": "the batch path replays the window, byte-equal",
        "parity_test": "tests/test_torch_incremental.py::"
                       "test_noise_profiles_serve_byte_equal",
    },
}

# ---- kernel contracts (TC rules) -------------------------------------------
# Every counted kernel wrapper of ops/ (a function whose ``.launches``
# counts its launches), with its plain version (the CPU path and the
# card's reference, which TC001 runs on meta tensors) and the card's
# ``extern "C"`` entry points it calls (the ABI pass's seven, among them
# relax_cluster's occupancy query). Three-sided (tensorcontract TC002):
# a counted wrapper missing here, an entry naming no counted wrapper, and
# a card entry point no wrapper claims each fail lint. The JAX package's
# counterpart lists its jitted entries.
KERNEL_CONTRACTS: Dict[str, Dict[str, object]] = {
    "reporter_tpu_torch/ops/viterbi.py::viterbi_cuda": {
        "plain": "reporter_tpu_torch/matcher/hmm.py::viterbi_decode_batch",
        "entries": ("viterbi_decode",),
        "doc": "batched decode -> (B,T) paths + (B,) scores",
    },
    "reporter_tpu_torch/ops/incremental.py::incremental_steps_cuda": {
        "plain": "reporter_tpu_torch/ops/incremental.py::"
                 "incremental_steps_plain",
        "entries": ("incremental_steps",),
        "doc": "R decode steps for N carried traces -> (R,N,K) scores, "
               "(R,N,K) bp, (R,N) restart anchors",
    },
    "reporter_tpu_torch/ops/route_relax.py::relax_cuda": {
        "plain": "reporter_tpu_torch/ops/route_relax.py::relax_csr",
        "entries": ("relax",),
        "doc": "multi-source bounded relaxation in one block -> (S,N) "
               "dist/time kernels, sweeps, converged",
    },
    "reporter_tpu_torch/ops/route_relax.py::relax_cluster_cuda": {
        "plain": "reporter_tpu_torch/ops/route_relax.py::relax_csr",
        "entries": ("relax_cluster", "relax_cluster_occupancy"),
        "doc": "the relaxation over a thread-block cluster",
    },
    "reporter_tpu_torch/ops/route_relax.py::relax_global_cuda": {
        "plain": "reporter_tpu_torch/ops/route_relax.py::relax_csr",
        "entries": ("relax_global",),
        "doc": "the relaxation with its state in global memory",
    },
    "reporter_tpu_torch/ops/route_relax.py::pair_costs_cuda": {
        "plain": "reporter_tpu_torch/ops/route_relax.py::"
                 "pair_costs_packed",
        "entries": ("pair_costs",),
        "doc": "route tensor from two packed blobs -> (B,T-1,K,K) costs "
               "+ max_finite",
    },
}

# ---- device lanes and host syncs (DP rules) --------------------------------
# DEVICE_LANES are the matcher's lane stages and the prep thread's route
# fill, the roots the placement pass walks (the submits go through
# SegmentMatcher._lane_dispatch and _lane_drain, which no structural
# detection sees).
# SYNC_POINTS are the functions allowed to bring device values to the
# host (.cpu(), .numpy(), .item(), .tolist(), float(), an event's or the
# device's synchronize): the walk stops there. Each names its counterpart
# in the JAX package's registry. Two-sided: an entry naming no function
# fails lint (placement DP001/DP003).
DEVICE_LANES: Dict[str, str] = {
    "reporter_tpu_torch/matcher/matcher.py::SegmentMatcher._dispatch_stage":
        "dispatch lane: upload, launch, async device-to-host copy "
        "(reference SegmentMatcher._dispatch_stage)",
    "reporter_tpu_torch/matcher/matcher.py::SegmentMatcher._drain_stage":
        "drain lane: the copy's event wait, then assembly (reference "
        "SegmentMatcher._drain_stage)",
    "reporter_tpu_torch/graph/route_device.py::DeviceRouteKernel.fill_prep":
        "prep-thread route fill on the native skip_routes path "
        "(reference DeviceRouteKernel.fill_prep)",
}

SYNC_POINTS: Dict[str, str] = {
    "reporter_tpu_torch/matcher/matcher.py::SegmentMatcher._drain_stage":
        "the device-to-host gather: the paths' event wait under "
        "matcher.decode_wait (reference SegmentMatcher._drain_stage)",
    "reporter_tpu_torch/matcher/batchpad.py::PaddedBatch.finalize_wire":
        "deferred route resolve and wire-dtype decision at dispatch "
        "(reference PaddedBatch.finalize_wire)",
    "reporter_tpu_torch/graph/route_device.py::DeferredRoutes.write_back":
        "route tensor written into the prep dict on the host (reference "
        "DeferredRoutes.write_back)",
}

__all__ = ["CONFIG_KEYS", "METRICS", "FAULT_SITES", "DURABLE_MODULES",
           "EPOCH_COMMIT_CONTRACTS", "FALLBACK_PAIRS", "KERNEL_CONTRACTS",
           "DEVICE_LANES", "SYNC_POINTS"]
