"""Supervised task spawning: the compliant spawner for lint rule
``task-orphan``.

``asyncio.ensure_future``/``create_task`` hand back a handle that silently
swallows any exception nobody retrieves: a crashed pump, accept loop, or
flush task disappears until interpreter shutdown ("Task exception was never
retrieved"), long after the damage.  ``spawn_logged`` attaches an
exception-logging done-callback at the spawn site so every background task
failure surfaces in the node's log the moment it happens.

Use this for every task whose handle is only stored for later ``cancel()``
(task lists, per-object handles).  Tasks that are *awaited* — where the
awaiter observes the exception — should keep using ``ensure_future``
directly, with an inline ``# lint: ignore[task-orphan]`` naming the awaiter.
"""
from __future__ import annotations

import asyncio
import logging
from typing import Coroutine, Optional


def spawn_logged(
    coro: Coroutine,
    log: logging.Logger,
    name: Optional[str] = None,
) -> asyncio.Task:
    """Spawn ``coro`` with an exception-logging done-callback.

    Cancellation is the normal shutdown path for supervised background tasks
    and is not logged.  The task handle is returned for ``cancel()``; callers
    need not (and usually do not) await it.
    """
    label = name or getattr(coro, "__qualname__", None) or repr(coro)
    task = asyncio.ensure_future(coro)

    def _log_failure(t: asyncio.Task) -> None:
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            log.error(
                "background task %s crashed: %r", label, exc, exc_info=exc
            )

    task.add_done_callback(_log_failure)
    return task


__all__ = ["spawn_logged"]
