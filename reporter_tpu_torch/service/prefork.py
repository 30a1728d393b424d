"""Pre-fork ``SO_REUSEPORT`` multi-process serving.

One ``ThreadingHTTPServer`` process is GIL-bound: every handler thread,
the dispatch loop and the Python halves of match and serialise share one
interpreter. ``--procs N`` is the process-per-core multiplier: the parent
forks N workers, each binds the SAME ``(host, port)`` with
``SO_REUSEPORT`` (``server.ReusePortThreadingHTTPServer``) and the kernel
spreads accepted connections across them — no shared accept lock, no
proxy hop, and each worker owns a whole interpreter, dispatcher and
device.

Fork discipline — everything heavy happens after the fork:

- the parent calls :func:`serve_prefork` with a ``make_service(slot,
  procs)`` thunk and never builds a matcher, a CUDA context or a
  dispatcher itself: it touches neither ``torch.cuda`` nor any torch op,
  since neither the CUDA driver nor a started OpenMP pool survives a
  fork. Each worker runs the thunk after the fork, and a worker that
  cannot open its card exits non-zero, logged;
- module singletons that do predate the fork are reset in the child by
  the :mod:`..utils.forksafe` hooks: the metrics registry (each worker's
  ``/stats`` counts its own work), the armed fault spec (each worker
  replays it from its first call), the dead-letter spool's byte
  estimates and the pressure ladder (each worker starts at ``normal``
  and builds its own admission gate with its service).

Supervision: the parent is a waitpid loop — restart a dead worker in the
same slot, with exponential backoff against crash loops, within an
optional restart budget. An rc-137 exit (SIGKILL) is logged as such.
SIGTERM / SIGINT to the parent TERMs every worker and reaps them; worker
exits during shutdown do not restart. With a flight-recorder dump
directory (the config's ``flightrec_dir``) each slot dumps into its own
``p<slot>`` directory under it, and the parent lists a dead worker's
postmortems (``flightrec-<pid>-*``) when it logs the death.
"""
from __future__ import annotations

import errno
import glob
import logging
import os
import signal
import time
from typing import Callable, Dict, Optional

from ..obs import flightrec
# imported here so their fork resets are registered before any fork
from ..utils import faults, spool  # noqa: F401
from . import admission  # noqa: F401

logger = logging.getLogger("reporter_tpu_torch.prefork")

#: consecutive fast-crash backoff ceiling (seconds); the first restart
#: in a slot is immediate, a crash-looping slot converges to this pace
MAX_BACKOFF_S = 5.0
#: a worker that lived at least this long resets its slot's crash count
HEALTHY_AGE_S = 10.0


def worker_main(slot: int, make_service: Callable[[int, int], object],
                host: str, port: int, procs: int,
                pool_size: int) -> int:
    """One worker's whole life, run just after the fork: build the
    service for the slot (device, native runtime, dispatcher — all after
    the fork), bind the shared port with ``SO_REUSEPORT`` and serve until
    TERMed. Returns an exit code (the caller ``os._exit``\\ s it — a
    worker must never fall back into the parent's stack)."""
    # the parent's supervisor handlers are not ours: TERM must close
    # the listener and exit this process, not set the parent's flag
    httpd_box: Dict[str, object] = {}

    def _term(signum, frame):
        srv = httpd_box.get("httpd")
        if srv is not None:
            # shutdown() BLOCKS until serve_forever exits — and this
            # handler runs in the very thread serve_forever occupies,
            # so calling it inline would deadlock the worker against
            # itself. A helper thread lets the handler return, the
            # loop notice the flag, and in-flight requests finish.
            import threading
            threading.Thread(target=srv.shutdown,  # type: ignore
                             daemon=True).start()
        else:
            os._exit(0)

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # parent owns ^C
    root = flightrec.dump_dir()
    if root:
        flightrec.set_dump_dir(slot_dump_dir(root, slot))

    from ..utils import metrics
    from .server import make_server
    service = make_service(slot, procs)
    # response identity header
    service.proc_tag = f"p{slot}:{os.getpid()}"  # type: ignore[attr-defined]
    metrics.count("service.procs.worker_start")
    httpd = make_server(service, host, port, pool_size, reuse_port=True)
    httpd_box["httpd"] = httpd
    logger.info("prefork worker p%d (pid %d) serving on %s:%d",
                slot, os.getpid(), host, port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        try:
            httpd.server_close()
        except Exception:
            pass
    return 0


def slot_dump_dir(root: str, slot: int) -> str:
    """The flight-recorder directory of worker ``slot`` under ``root``."""
    return os.path.join(root, f"p{slot}")


def _flightrec_dumps(slot: int, pid: int) -> list:
    """A dead worker's postmortems: its slot's directory, its pid."""
    root = flightrec.dump_dir()
    if not root:
        return []
    return sorted(glob.glob(os.path.join(slot_dump_dir(root, slot),
                                         f"flightrec-{pid}-*")))


def _exit_code(status: int) -> int:
    """waitpid status -> shell-style exit code (signal n => 128+n)."""
    if os.WIFSIGNALED(status):
        return 128 + os.WTERMSIG(status)
    if os.WIFEXITED(status):
        return os.WEXITSTATUS(status)
    return 1


def serve_prefork(make_service: Callable[[int, int], object], host: str,
                  port: int, procs: int, pool_size: int,
                  max_total_restarts: Optional[int] = None) -> int:
    """Fork ``procs`` workers sharing (host, port) via ``SO_REUSEPORT``,
    each with ``pool_size`` handler threads, and supervise them: restart-on-crash with per-slot backoff, rc-137
    aware logging. Blocks until SIGTERM/SIGINT, then TERMs and reaps
    every worker. ``max_total_restarts`` bounds the restart budget (None
    = supervise forever); spending it ends the run with exit code 1.
    Returns a process exit code."""
    procs = max(1, int(procs))
    shutting_down = {"flag": False}

    def _stop(signum, frame):
        shutting_down["flag"] = True

    old_term = signal.signal(signal.SIGTERM, _stop)
    old_int = signal.signal(signal.SIGINT, _stop)

    slot_of: Dict[int, int] = {}           # pid -> slot
    started_at: Dict[int, float] = {}      # pid -> monotonic start
    crashes: Dict[int, int] = {}           # slot -> consecutive fast crashes
    respawn_at: Dict[int, float] = {}      # slot -> earliest respawn time
    restarts = 0

    def _spawn(slot: int) -> int:
        pid = os.fork()
        if pid == 0:
            # child: never unwind into the supervisor's stack
            code = 1
            try:
                code = worker_main(slot, make_service, host, port, procs,
                                   pool_size)
            except BaseException:
                logger.exception("prefork worker p%d died in startup",
                                 slot)
            finally:
                os._exit(code)
        slot_of[pid] = slot
        started_at[pid] = time.monotonic()
        logger.info("prefork: started worker p%d as pid %d", slot, pid)
        return pid

    from ..utils import metrics
    for slot in range(procs):
        _spawn(slot)
        metrics.count("service.procs.spawned")

    rc = 0
    try:
        # WNOHANG poll rather than a blocking waitpid: PEP 475 restarts
        # a blocking waitpid after the SIGTERM handler returns, so the
        # shutdown flag would never be seen until a child happened to die
        while (slot_of or respawn_at) and not shutting_down["flag"]:
            # due backed-off respawns first: the backoff is a DEADLINE,
            # never an inline sleep — a crash-looping slot must not
            # stall reaping of other workers or SIGTERM shutdown
            now = time.monotonic()
            for slot in [s for s, at in respawn_at.items() if at <= now]:
                del respawn_at[slot]
                restarts += 1
                metrics.count("service.procs.restarts")
                _spawn(slot)
            try:
                pid, status = os.waitpid(-1, os.WNOHANG)
            except OSError as e:
                if e.errno == errno.ECHILD:
                    if not respawn_at:
                        break
                    time.sleep(0.05)
                    continue
                raise
            if pid == 0:
                time.sleep(0.05)
                continue
            slot = slot_of.pop(pid, None)
            if slot is None:
                continue  # transient fork-exec child (subprocess etc.)
            age = time.monotonic() - started_at.pop(pid, time.monotonic())
            code = _exit_code(status)
            if shutting_down["flag"]:
                logger.info("prefork: worker p%d (pid %d) exited rc %d "
                            "during shutdown", slot, pid, code)
                continue
            metrics.count("service.procs.deaths")
            dumps = _flightrec_dumps(slot, pid)
            if code == 137:
                # SIGKILL-grade: OOM killer, chaos harness, operator
                logger.error("prefork: worker p%d (pid %d) SIGKILLed "
                             "(rc 137) after %.1fs; flight-recorder dumps "
                             "%s", slot, pid, age, dumps)
            else:
                logger.error("prefork: worker p%d (pid %d) exited rc %d "
                             "after %.1fs; flight-recorder dumps %s", slot,
                             pid, code, age, dumps)
            if max_total_restarts is not None \
                    and restarts >= max_total_restarts:
                logger.error("prefork: restart budget exhausted; "
                             "shutting down")
                rc = 1
                shutting_down["flag"] = True
                continue
            # backoff against a crash-looping slot; a worker that
            # served healthily resets its slot's streak. The respawn is
            # SCHEDULED (picked up at the top of the loop), keeping the
            # supervisor responsive for other deaths and for shutdown
            crashes[slot] = 0 if age >= HEALTHY_AGE_S \
                else crashes.get(slot, 0) + 1
            delay = min(MAX_BACKOFF_S, 0.1 * (2 ** crashes[slot])) \
                if crashes[slot] else 0.0
            respawn_at[slot] = time.monotonic() + delay
    finally:
        # TERM + reap every survivor, restore the old handlers
        for pid in list(slot_of):
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + 10.0
        for pid in list(slot_of):
            try:
                while time.monotonic() < deadline:
                    done, _ = os.waitpid(pid, os.WNOHANG)
                    if done == pid:
                        break
                    time.sleep(0.05)
                else:
                    os.kill(pid, signal.SIGKILL)
                    os.waitpid(pid, 0)
            except (ChildProcessError, ProcessLookupError):
                pass
            slot_of.pop(pid, None)
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
    logger.info("prefork: supervisor exiting rc %d (%d restarts)",
                rc, restarts)
    return rc


__all__ = ["serve_prefork", "worker_main"]
