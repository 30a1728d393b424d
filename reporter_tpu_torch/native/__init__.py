"""ctypes binding of the C++ host runtime (``csrc/host_runtime.cpp``).

The runtime does the matcher's host work in native code: the whole-chunk
batched prep (candidates, kept points, case codes and route tensors, fanned
out over C++ threads), the candidate lookup and route rows of the points
a trace appends to its incremental decode (``candidates``,
``route_matrices``), the batched assembly of decoded paths into segment
run columns, and the ``/report`` wire writer over those columns.

The library is compiled with g++ into ``reporter_tpu_torch/_build/`` at
first use (:func:`load`), never at import, and loaded with ``ctypes``
after an ABI handshake. A missing compiler, a failed build or an ABI
mismatch raises ``RuntimeError``: nothing falls back to another
implementation. Several processes may build at once; each compiles to a
name of its own and moves the result into place.

ctypes releases the GIL during calls, so the matcher's device lanes run
native assembly beside the prep thread.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import weakref
from pathlib import Path

import numpy as np

from ..utils import metrics

SOURCE = Path(__file__).resolve().parent / "csrc" / "host_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
#: the C++ compiler the library is built with
CXX = "g++"
#: must equal host_runtime.cpp's rt_abi_version()
ABI_VERSION = 14
#: prepare_batch's phase_ns slots, counted as ``prep.phase.<name>_ns``
PHASES = ("candidates", "select", "routes")

_lock = threading.Lock()
_lib = None


def cxx_flags() -> tuple:
    """The build's flags: F16C wire casts (``rt_f32_to_f16``) when the
    build host's CPU has the instructions; the scalar path otherwise."""
    flags = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
    try:
        with open("/proc/cpuinfo") as f:
            f16c = "f16c" in f.read()
    except OSError:
        f16c = False
    return flags + (("-mavx", "-mf16c") if f16c else ())


def _build() -> Path:
    """Compile the library once per source and flags; returns its path."""
    flags = cxx_flags()
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()
                         ).hexdigest()[:16]
    out = BUILD_DIR / f"libreporter_host-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *flags, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=600)
    except FileNotFoundError as e:
        raise RuntimeError(f"C++ compiler {CXX!r} not found: the host "
                           f"runtime is built with g++") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed ({proc.returncode}) building "
                           f"{SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The built, handshaken and bound library (built on first call)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(str(_build())))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """ABI handshake, then the argument types of every entry point used."""
    try:
        lib.rt_abi_version.restype = ctypes.c_int32
        lib.rt_abi_version.argtypes = []
        got = int(lib.rt_abi_version())
    except AttributeError:
        got = -1
    if got != ABI_VERSION:
        raise RuntimeError(f"host runtime ABI mismatch: library {got}, "
                           f"binding {ABI_VERSION}")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    vp, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                         ctypes.c_double)
    lib.rt_graph_create.restype = vp
    lib.rt_graph_create.argtypes = [i64, i64, f64p, f64p, i32p, i32p, f32p,
                                    f32p, f64]
    lib.rt_graph_destroy.argtypes = [vp]
    lib.rt_cache_clear.argtypes = [vp]
    lib.rt_cache_size.argtypes = [vp]
    lib.rt_cache_size.restype = i64
    lib.rt_route_memo_stats.argtypes = [vp, i64p]
    lib.rt_f32_to_f16.argtypes = [f32p, u16p, i64]
    lib.rt_candidates.argtypes = [vp, i64, f64p, f64p, i32, f64, i32p, f32p,
                                  f32p, f32p, f32p]
    # dt is nullable (no time bound), so it binds as a raw pointer
    lib.rt_route_matrices.argtypes = [
        vp, i64, i32, i32p, f32p, f32p, ctypes.POINTER(f64), f64, f64, f64,
        f64, f64, f64, f32p]
    lib.rt_prepare_batch.argtypes = [
        vp, i64, i64p, f64p, f64p, f64p, f64, f64, i32, i32,
        f64, f64, f64, f64, f64, f64, f64, f64, f64, f64, i32, i32,
        i32p, f32p, f32p, f32p, f32p, i32p, i32p, i32p, f32p, u8p, f32p,
        i64p, f64p]
    lib.rt_assemble_batch.restype = i64
    lib.rt_assemble_batch.argtypes = [
        vp, i64, i32, i32, i32p, i32p, f32p, f32p, i32p, i32p, i32p, f32p,
        i64p, f64p, u8p, i64p, f32p, u8p, i64p, f64p, i64,
        f64, f64, f64, f64, i64,
        i64p, i64p, u8p, f64p, f64p, i32p, i32p, i32p, i32p, i64p, i64p]
    # the wire writer: per-trace calls over a chunk-shared column set, so
    # every pointer binds as a raw c_void_p (the ten column addresses
    # travel as one packed int64 array, see _writer_args): ndpointer's
    # per-call checks of ten arrays cost more than the serialisation
    lib.rt_json_double.restype = i64
    lib.rt_json_double.argtypes = [f64, u8p]
    lib.rt_render_segments_json.restype = i64
    lib.rt_render_segments_json.argtypes = [vp, i64, i64, ctypes.c_char_p,
                                            i64, vp, i64]
    lib.rt_report_json.restype = i64
    lib.rt_report_json.argtypes = [vp, i64, i64, f64, f64, i32, i32, vp,
                                   i64]
    lib.rt_report_json_batch.restype = i64
    lib.rt_report_json_batch.argtypes = [vp, vp, vp, i64, f64, i32, i32, vp,
                                         i64, vp]
    return lib


# ---- the /report wire writer ------------------------------------------------
# Free functions over a chunk's run-column arrays (matcher.RunColumns
# .arrays): no graph handle, no shared state.

_WRITER_COLS = ("seg_id", "internal", "start", "end", "length", "queue",
                "begin_idx", "end_idx", "way_off", "ways")
#: the writer's column dtypes, column for column with _WRITER_COLS
_WIRE_DTYPES = (np.int64, np.uint8, np.float64, np.float64, np.int32,
                np.int32, np.int32, np.int32, np.int64, np.int64)


def _writer_args(arrays: dict) -> tuple:
    """Per-chunk writer state, cached on the arrays dict, so every trace
    of a chunk reuses one coercion and one packing of the column
    pointers. Returns ``(col_addrs_ptr, way_off_list)``: the address of a
    packed int64 array of the ten column base addresses (the C side's
    ``unpack_cols`` order) and the way-offset column as a list for sizing
    buffers. The coerced arrays ride in the cache entry, which keeps the
    pointers alive."""
    cached = arrays.get("_wire_ptrs")
    if cached is None:
        cols = tuple(np.ascontiguousarray(arrays[k], dtype=dt)
                     for k, dt in zip(_WRITER_COLS, _WIRE_DTYPES))
        addrs = np.array([c.ctypes.data for c in cols], dtype=np.int64)
        cached = (addrs.ctypes.data, cols[8].tolist(), cols, addrs)
        arrays["_wire_ptrs"] = cached
    return cached


def json_double(v: float) -> bytes:
    """The C writer's bytes for one double: ``repr(v)`` as JSON spells it."""
    out = np.empty(32, np.uint8)
    n = int(load().rt_json_double(float(v), out))
    return out[:n].tobytes()


def write_segments_json(arrays: dict, lo: int, hi: int,
                        mode_json: bytes) -> memoryview:
    """``{"segments":[...],"mode":...}`` bytes for run columns [lo, hi),
    byte-equal to ``matcher.render_segments_json_py``."""
    fn = load().rt_render_segments_json
    col_addrs, way_off = _writer_args(arrays)[:2]
    # fixed keys and digits per run and per way id; grown on a -1 return
    cap = 320 * (hi - lo + 1) + 24 * (way_off[hi] - way_off[lo]) + 1024
    while True:
        out = np.empty(cap, np.uint8)
        n = fn(col_addrs, lo, hi, mode_json, len(mode_json),
               out.ctypes.data, cap)
        if n >= 0:
            return out.data[:n]
        cap *= 4


def write_report_json_batch(arrays: dict, threshold_sec: float,
                            report_mask: int, transition_mask: int):
    """Every trace's ``/report`` body of a chunk in one C call and one
    buffer. Needs the chunk layout the matcher attaches to its
    RunColumns (``_run_off``: per-trace run spans, ``_trace_end``:
    per-trace last point times); returns ``(buffer, offsets)``, trace
    ``t``'s body being ``buffer[offsets[t]:offsets[t + 1]]``."""
    fn = load().rt_report_json_batch
    run_off = arrays["_run_off"]
    trace_ends = arrays["_trace_end"]
    n = len(run_off) - 1
    col_addrs, way_off = _writer_args(arrays)[:2]
    offsets = np.empty(n + 1, np.int64)
    # size from the meaningful prefix only: the assembler over-allocates
    # the way_off column, so entries past run_off[-1] are uninitialised
    n_runs = int(run_off[-1])
    cap = 320 * (n_runs + n) + 24 * way_off[n_runs] + 448 * n + 1024
    while True:
        out = np.empty(cap, np.uint8)
        total = fn(col_addrs, run_off.ctypes.data, trace_ends.ctypes.data, n,
                   threshold_sec, report_mask, transition_mask,
                   out.ctypes.data, cap, offsets.ctypes.data)
        if total >= 0:
            return out, offsets.tolist()
        cap *= 4


def write_report_json(arrays: dict, lo: int, hi: int, trace_end: float,
                      threshold_sec: float, report_mask: int,
                      transition_mask: int) -> memoryview:
    """The whole ``/report`` body for run columns [lo, hi) in one buffer,
    byte-equal to ``service.report._report_json_py``."""
    fn = load().rt_report_json
    col_addrs, way_off = _writer_args(arrays)[:2]
    cap = 320 * (hi - lo + 1) + 24 * (way_off[hi] - way_off[lo]) + 1024
    while True:
        out = np.empty(cap, np.uint8)
        n = fn(col_addrs, lo, hi, trace_end, threshold_sec, report_mask,
               transition_mask, out.ctypes.data, cap)
        if n >= 0:
            return out.data[:n]
        cap *= 4


def _destroy(lib, handle, owner_pid: int) -> None:
    # never destroy a parent's handle from a forked child: the pool
    # threads the destructor joins exist only in the owning process
    if os.getpid() == owner_pid:
        lib.rt_graph_destroy(handle)


class NativeRuntime:
    """The C++ host runtime bound to one RoadNetwork: its own spatial grid,
    route cache, route-pair memo and prep worker pool."""

    def __init__(self, net, cell_m: float):
        lib = load()
        self._lib = lib
        self.net = net
        # fork guard: the handle's C++ worker-pool threads do not survive
        # os.fork(), and a child calling through the inherited handle
        # would hang on a condvar no thread signals
        self._owner_pid = os.getpid()
        # rt_graph_create copies everything into C++ vectors, so these
        # staging arrays only need to live for the call
        nx, ny = net.node_xy()
        self._handle = lib.rt_graph_create(
            net.num_nodes, net.num_edges,
            np.ascontiguousarray(nx, dtype=np.float64),
            np.ascontiguousarray(ny, dtype=np.float64),
            np.ascontiguousarray(net.edge_start, dtype=np.int32),
            np.ascontiguousarray(net.edge_end, dtype=np.int32),
            np.ascontiguousarray(net.edge_length_m, dtype=np.float32),
            np.ascontiguousarray(net.edge_speed_kph, dtype=np.float32),
            float(cell_m))
        weakref.finalize(self, _destroy, lib, self._handle, self._owner_pid)
        self._asm_cols = None

    def _check_owner(self) -> None:
        if os.getpid() != self._owner_pid:
            raise RuntimeError(
                "NativeRuntime used across fork (its C++ worker-pool "
                "threads did not survive); build a new SegmentMatcher in "
                "the child process")

    def candidates(self, lat, lon, k: int, search_radius_m: float = 50.0):
        """The K nearest edges within ``search_radius_m`` of each point, as
        a ``graph.spatial.CandidateSet`` (the semantics of
        ``SpatialGrid.candidates``), in one native call."""
        from ..graph.spatial import CandidateSet

        self._check_owner()
        to_xy, _ = self.net.projection()
        px, py = to_xy(np.asarray(lat, dtype=np.float64),
                       np.asarray(lon, dtype=np.float64))
        px = np.ascontiguousarray(np.atleast_1d(px), dtype=np.float64)
        py = np.ascontiguousarray(np.atleast_1d(py), dtype=np.float64)
        T = len(px)
        edge = np.empty((T, k), dtype=np.int32)
        dist = np.empty((T, k), dtype=np.float32)
        off = np.empty((T, k), dtype=np.float32)
        qx = np.empty((T, k), dtype=np.float32)
        qy = np.empty((T, k), dtype=np.float32)
        self._lib.rt_candidates(self._handle, T, px, py, k,
                                float(search_radius_m), edge, dist, off, qx,
                                qy)
        return CandidateSet(edge, dist, off, qx, qy)

    def route_matrices(self, cands, gc_dist,
                       max_route_distance_factor: float = 5.0,
                       min_bound_m: float = 500.0,
                       backward_tolerance_m: float = 0.0,
                       dt=None,
                       max_route_time_factor: float = 0.0,
                       min_time_bound_s: float = 15.0,
                       turn_penalty_factor: float = 0.0) -> np.ndarray:
        """(T-1, K, K) route distances between consecutive candidate rows
        of ``cands``, the semantics of ``graph.route.
        candidate_route_matrices``. ``gc_dist`` is the (T-1,) great-circle
        distances, ``dt`` the (T-1,) probe time deltas in seconds or None
        (no time bound)."""
        self._check_owner()
        T, K = cands.edge_ids.shape
        out = np.empty((max(T - 1, 0), K, K), dtype=np.float32)
        if T < 2:
            return out
        edge = np.ascontiguousarray(cands.edge_ids, dtype=np.int32)
        off = np.ascontiguousarray(cands.offset_m, dtype=np.float32)
        gc = np.ascontiguousarray(gc_dist, dtype=np.float32)
        dt_ptr = None
        if dt is not None:
            dt_arr = np.ascontiguousarray(dt, dtype=np.float64)
            if dt_arr.shape != (T - 1,):
                raise ValueError(f"dt must be (T-1,)={T - 1}, got "
                                 f"{dt_arr.shape}")
            dt_ptr = dt_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        self._lib.rt_route_matrices(
            self._handle, T, K, edge, off, gc, dt_ptr,
            float(max_route_distance_factor), float(min_bound_m),
            float(backward_tolerance_m), float(max_route_time_factor),
            float(min_time_bound_s), float(turn_penalty_factor), out)
        return out

    def prepare_batch(self, pt_off, lat, lon, times, T: int, K: int,
                      search_radius: float, interpolation_distance: float,
                      breakage_distance: float,
                      max_route_distance_factor: float = 5.0,
                      min_bound_m: float = 500.0,
                      backward_tolerance_m: float = 0.0,
                      max_route_time_factor: float = 0.0,
                      min_time_bound_s: float = 15.0,
                      turn_penalty_factor: float = 0.0,
                      prune_margin_m: float = 0.0,
                      skip_routes: bool = False,
                      n_threads: int = 0, n_rows: int | None = None) -> dict:
        """Prepare B traces in one native call, straight into padded
        (rows, T, ...) tensors: candidates, jitter and no-candidate
        filtering, case codes and route matrices (the semantics of
        ``batchpad.prepare_traces_numpy``), over C++ threads. ``pt_off``
        is (B+1,) int64 offsets into the flat lat/lon/times arrays;
        ``n_rows`` >= B adds all-SKIP filler rows.

        ``prune_margin_m`` > 0 prunes candidates after kept selection:
        each point's distance-sorted candidates are cut where dist >
        dist[0] + margin (the best always survives). ``skip_routes``
        skips only the route search: the device route kernel
        (``graph/route_device.py``) then writes route rows [0, n-1) of
        every live trace; every other tensor, ``dt`` included, is
        computed as usual, and the rows from n-1 on keep their tail fill.

        Returns the filled tensors: edge_ids (rows,T,K) i32, dist_m and
        offset_m (rows,T,K) f32, route_m (rows,T,K,K) f32, gc_m (rows,T)
        f32, case (rows,T) i32, kept_idx (rows,T) i32 (-1 pad), num_kept
        (rows,) i32, dwell (rows,) f32, dt (rows,T) f64 kept-point time
        deltas (-1 where the time bound does not arm), has_cands (points,)
        u8, max_finite (1,) f32 (the largest finite distance written) and
        phase_ns (3,) i64 (candidates, select, routes; summed over
        threads, and added to the ``prep.phase.<name>_ns`` counters).
        route_m and gc_m carry T time rows: the last is a dead step,
        which the decode takes and ignores.
        """
        self._check_owner()
        pt_off = np.ascontiguousarray(pt_off, dtype=np.int64)
        lat = np.ascontiguousarray(lat, dtype=np.float64)
        lon = np.ascontiguousarray(lon, dtype=np.float64)
        times = np.ascontiguousarray(times, dtype=np.float64)
        B = len(pt_off) - 1
        rows = n_rows if n_rows is not None else B
        if rows < B:
            raise ValueError(f"n_rows={rows} < B={B}")
        # np.empty: the C++ call writes every row of its B traces, live
        # prefixes and pad sentinels alike; only filler rows are filled here
        out = {
            "edge_ids": np.empty((rows, T, K), np.int32),
            "dist_m": np.empty((rows, T, K), np.float32),
            "offset_m": np.empty((rows, T, K), np.float32),
            "route_m": np.empty((rows, T, K, K), np.float32),
            "gc_m": np.empty((rows, T), np.float32),
            "case": np.empty((rows, T), np.int32),
            "kept_idx": np.empty((rows, T), np.int32),
            "num_kept": np.zeros(rows, np.int32),
            "dwell": np.zeros(rows, np.float32),
            "dt": np.empty((rows, T), np.float64),
            "has_cands": np.zeros(max(int(pt_off[-1]), 1), np.uint8),
            "max_finite": np.zeros(1, np.float32),
            "phase_ns": np.zeros(3, np.int64),
        }
        if rows > B:
            # deferred: matcher imports this module
            from ..graph.route import UNREACHABLE
            from ..graph.spatial import PAD_DIST, PAD_EDGE
            from ..matcher.hmm import SKIP
            out["edge_ids"][B:] = PAD_EDGE
            out["dist_m"][B:] = PAD_DIST
            out["offset_m"][B:] = 0.0
            out["route_m"][B:] = UNREACHABLE
            out["gc_m"][B:] = 0.0
            out["case"][B:] = SKIP
            out["kept_idx"][B:] = -1
            out["dt"][B:] = -1.0
        lat0, lon0 = self.net.projection_anchor()
        self._lib.rt_prepare_batch(
            self._handle, B, pt_off, lat, lon, times,
            float(lat0), float(lon0), T, K,
            float(search_radius), float(interpolation_distance),
            float(breakage_distance), float(max_route_distance_factor),
            float(min_bound_m), float(backward_tolerance_m),
            float(max_route_time_factor), float(min_time_bound_s),
            float(turn_penalty_factor), float(prune_margin_m),
            int(bool(skip_routes)), int(n_threads),
            out["edge_ids"], out["dist_m"], out["offset_m"],
            out["route_m"], out["gc_m"], out["case"], out["kept_idx"],
            out["num_kept"], out["dwell"], out["has_cands"],
            out["max_finite"], out["phase_ns"], out["dt"])
        for name, ns in zip(PHASES, out["phase_ns"].tolist()):
            if ns > 0:
                metrics.count(f"prep.phase.{name}_ns", ns)
        return out

    def to_f16(self, arr: np.ndarray) -> np.ndarray:
        """f32 -> f16 wire cast (F16C where built with it): bit-equal to
        numpy's ``astype(np.float16)``, round to nearest even, overflow
        to inf."""
        src = np.ascontiguousarray(arr, dtype=np.float32)
        out = np.empty(src.shape, dtype=np.float16)
        self._lib.rt_f32_to_f16(src.reshape(-1),
                                out.view(np.uint16).reshape(-1), src.size)
        return out

    def _assembly_columns(self) -> dict:
        """Graph columns the native assembler reads, staged contiguous
        once per runtime (a sorted segment-length table for the C++
        binary search)."""
        if self._asm_cols is None:
            net = self.net
            seg_ids = np.array(sorted(net.segment_length_m), dtype=np.int64)
            seg_lens = np.array(
                [net.segment_length_m[int(s)] for s in seg_ids],
                dtype=np.float64)
            self._asm_cols = {
                "edge_seg_id": np.ascontiguousarray(
                    net.edge_segment_id, dtype=np.int64),
                "edge_seg_off": np.ascontiguousarray(
                    net.edge_segment_offset_m, dtype=np.float32),
                "edge_internal": np.ascontiguousarray(
                    net.edge_internal, dtype=np.uint8),
                "seg_ids": seg_ids,
                "seg_lens": seg_lens,
            }
        return self._asm_cols

    def assemble_batch(self, path, prep: dict, pt_off, times,
                       queue_threshold_kph: float,
                       interpolation_distance_m: float,
                       backward_tolerance_m: float = 25.0,
                       turn_penalty_factor: float = 0.0) -> dict:
        """Walk B decoded paths into segment runs in one native call
        (``matcher/assemble.py`` semantics).

        ``path`` is (B, T) decoded candidate indices (live rows only);
        ``prep`` the dict from :meth:`prepare_batch`. Returns the flat run
        columns seg_id, internal, start, end, length, queue, begin_idx,
        end_idx, way_off, ways, with run_off (B+1,) and n_runs.
        """
        self._check_owner()
        cols = self._assembly_columns()
        path = np.ascontiguousarray(path, dtype=np.int32)
        B, T = path.shape
        K = prep["edge_ids"].shape[2]
        num_kept = prep["num_kept"][:B]
        cap = max(int(num_kept.sum()), 1)
        run_off = np.empty(B + 1, dtype=np.int64)
        out = {
            "seg_id": np.empty(cap, np.int64),
            "internal": np.empty(cap, np.uint8),
            "start": np.empty(cap, np.float64),
            "end": np.empty(cap, np.float64),
            "length": np.empty(cap, np.int32),
            "queue": np.empty(cap, np.int32),
            "begin_idx": np.empty(cap, np.int32),
            "end_idx": np.empty(cap, np.int32),
            "way_off": np.empty(cap + 1, np.int64),
            "ways": np.empty(cap, np.int64),
        }
        n = self._lib.rt_assemble_batch(
            self._handle, B, T, K, path,
            prep["edge_ids"][:B], prep["offset_m"][:B],
            prep["route_m"][:B], prep["case"][:B], prep["kept_idx"][:B],
            np.ascontiguousarray(num_kept, dtype=np.int32),
            prep["dwell"][:B],
            np.ascontiguousarray(pt_off, dtype=np.int64),
            np.ascontiguousarray(times, dtype=np.float64),
            prep["has_cands"],
            cols["edge_seg_id"], cols["edge_seg_off"],
            cols["edge_internal"], cols["seg_ids"], cols["seg_lens"],
            len(cols["seg_ids"]),
            float(queue_threshold_kph), float(interpolation_distance_m),
            float(backward_tolerance_m), float(turn_penalty_factor),
            cap, run_off, out["seg_id"], out["internal"], out["start"],
            out["end"], out["length"], out["queue"], out["begin_idx"],
            out["end_idx"], out["way_off"], out["ways"])
        if n < 0:
            raise RuntimeError(f"rt_assemble_batch overflowed its capacity "
                               f"({cap} runs)")
        out["run_off"] = run_off
        out["n_runs"] = int(n)
        return out

    def cache_clear(self) -> None:
        self._lib.rt_cache_clear(self._handle)

    def cache_size(self) -> int:
        return int(self._lib.rt_cache_size(self._handle))

    def route_memo_stats(self) -> dict:
        """Counters of the cross-call (edge_from, edge_to) route-pair
        memo (capacity 1 << 18 pairs)."""
        out = np.zeros(4, np.int64)
        self._lib.rt_route_memo_stats(self._handle, out)
        return {"hits": int(out[0]), "misses": int(out[1]),
                "size": int(out[2]), "evictions": int(out[3])}
