"""Self-daemonization (reference ``engine/binutil/unix.go:12-29`` wraps
sevlyar/go-daemon for the per-process ``-d`` flag).

The classic UNIX double-fork: detach from the controlling terminal, start
a new session, and redirect stdio to a logfile so the supervisor STARTED
tag (``consts.SUPERVISOR_STARTED_TAG``) still lands somewhere the ops CLI
can poll. ``python -m goworld_tpu_torch start`` already detaches its
children via ``start_new_session``; ``-d`` is for running a single
process by hand. Fork before the process touches the card: a CUDA
context does not survive a fork.
"""

from __future__ import annotations

import os
import sys


def daemonize(logfile: str | None = None) -> None:
    """Fork into the background. Returns only in the daemon process."""
    if os.fork() > 0:
        os._exit(0)  # first parent exits
    os.setsid()
    if os.fork() > 0:
        os._exit(0)  # first child exits; grandchild has no session tty
    sys.stdout.flush()
    sys.stderr.flush()
    devnull = os.open(os.devnull, os.O_RDONLY)
    os.dup2(devnull, 0)
    os.close(devnull)
    out = os.open(
        logfile, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
    ) if logfile else os.open(os.devnull, os.O_WRONLY)
    os.dup2(out, 1)
    os.dup2(out, 2)
    os.close(out)
