"""Post-fork re-initialisation of process-wide singletons.

``os.fork()`` copies exactly one thread into the child: a lock another
thread held at fork time stays locked forever there, and counters
describe the parent's work. The pre-fork serving mode
(``service/prefork.py``) forks before any of that state gets
interesting, but fork safety must not depend on call ordering — so this
module gives each singleton-owning module a registered child-side reset
hook, run by ``os.register_at_fork(after_in_child=...)`` in registration
order.

Registered today: ``utils.metrics`` — the default registry's counters
and timers clear, so a child's ``/stats`` reports its own work.

Hooks must be idempotent, cheap and exception-free: they run on every
fork in the process (including subprocess's transient fork-exec
children), and a raising hook would poison unrelated forks. Failures
are logged and swallowed.
"""
from __future__ import annotations

import logging
import os
from typing import Callable, List

logger = logging.getLogger("reporter_tpu_torch.forksafe")

_hooks: List[Callable[[], None]] = []
_registered = False


def register(hook: Callable[[], None]) -> None:
    """Add a child-side reset hook (run in registration order). The
    process-wide ``register_at_fork`` handler installs lazily on the
    first registration — importing this module alone changes nothing."""
    global _registered
    _hooks.append(hook)
    if not _registered:
        os.register_at_fork(after_in_child=_run_hooks)
        _registered = True


def _run_hooks() -> None:
    for hook in _hooks:
        try:
            hook()
        except Exception as e:  # never poison an unrelated fork
            try:
                logger.error("post-fork reset hook %r failed: %s", hook, e)
            except Exception:
                pass


def hook_count() -> int:
    """Registered hook count (test surface)."""
    return len(_hooks)
