"""Crash-safe file writes and advisory locks (the port's own copy of
``repic_tpu.runtime.atomic``).

* :func:`atomic_write` — every artifact writer (BOX files, TSVs,
  pickles, the manifest) writes a same-directory temporary file and
  publishes it with one ``os.replace``: a reader sees the previous
  complete file or the new one, never a prefix.
* :func:`file_lock` — an ``flock`` on a ``.lock`` sibling that
  serialises a read-merge-replace cycle on a shared file (the
  capacity-config sidecar), so two processes do not drop each other's
  updates.
* :func:`try_claim` / :func:`commit_once` — create-once records
  (``O_CREAT | O_EXCL`` and ``os.link``), for records that must have
  exactly one writer.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "wt"):
    """Open ``path`` for writing through a same-directory temp file.

    On a clean exit the temp file is flushed, fsynced and renamed onto
    ``path``; on any exception it is removed and ``path`` keeps its
    previous content.  ``mode`` must be a write mode ("wt"/"wb").
    """
    if "a" in mode or "r" in mode or "+" in mode:
        raise ValueError(f"atomic_write requires a write mode, got {mode!r}")
    tmp = f"{path}.tmp{os.getpid()}"
    f = open(tmp, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
    except BaseException:
        f.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    f.close()
    os.replace(tmp, path)


@contextlib.contextmanager
def file_lock(path: str):
    """Exclusive advisory lock on ``path + ".lock"`` for the duration
    of the block (never on ``path`` itself: a replace would swap the
    locked inode away from a waiter).  The lock file stays in place.
    Without ``fcntl`` (non-POSIX) the block runs unlocked."""
    try:
        import fcntl
    except ImportError:  # pragma: no cover - non-POSIX
        yield
        return
    f = open(path + ".lock", "a")
    try:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        yield
    finally:
        with contextlib.suppress(OSError):
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)
        f.close()


def try_claim(path: str, payload: str) -> bool:
    """Create ``path`` holding ``payload``; False if it already exists.
    Of several concurrent claimants exactly one wins."""
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    with os.fdopen(fd, "w") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    return True


def commit_once(path: str, payload: str) -> bool:
    """Create-once commit of a COMPLETE ``path``; False if it exists.

    The payload lands in a unique temp file (flushed and fsynced) and
    is published with ``os.link``, which fails if another committer
    won: exactly one commit is published, and it is never torn."""
    import uuid

    # pid alone is not unique: two threads of one process may race
    tmp = f"{path}.tmp{os.getpid()}.{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    try:
        os.link(tmp, path)
        return True
    except FileExistsError:
        return False
    finally:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
