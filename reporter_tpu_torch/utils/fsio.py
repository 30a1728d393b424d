"""Crash-consistent file commits: the one atomic-write discipline.

Every durable write of the package (the dead-letter spool, and later the
datastore and state snapshots) follows the same four steps:

    1. write the whole payload to a dot-prefixed temp name in the target
       directory
    2. ``fsync`` the temp file: ``os.replace`` promises atomicity, not
       durability, and after a power loss an un-fsynced rename can
       surface as the new name with empty contents
    3. ``os.replace`` the temp name over the final name
    4. ``fsync`` the parent directory, so the rename itself is durable

Directory fsyncs are best-effort: some filesystems refuse O_RDONLY
directory descriptors, and "atomic but not power-loss durable" beats
refusing to run there. The port of ``reporter_tpu/utils/fsio.py``.
"""
from __future__ import annotations

import os


def fsync_path(path: str) -> None:
    """fsync one already-written file by path."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it is durable; best-effort
    where the platform refuses O_RDONLY directory descriptors."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _atomic_write(path: str, data: bytes) -> None:
    path = os.path.abspath(path)
    parent, name = os.path.split(path)
    tmp = os.path.join(parent, f".{name}.tmp-{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # a failed commit leaves no stray temp file for directory
        # scanners; the target is untouched either way
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(parent)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Commit ``data`` to ``path`` by tmp + fsync + replace + directory
    fsync. On any failure the previous contents of ``path`` are intact
    and no temp file is left behind."""
    _atomic_write(path, data)


def atomic_write_text(path: str, text: str,
                      encoding: str = "utf-8") -> None:
    """:func:`atomic_write_bytes` for str payloads."""
    _atomic_write(path, text.encode(encoding))


__all__ = ["fsync_path", "fsync_dir", "atomic_write_bytes",
           "atomic_write_text"]
