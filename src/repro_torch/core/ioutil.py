"""Small shared I/O helpers for the middleware's persistent state.

``atomic_json_dump`` (temp file + ``os.replace``) is the cross-process
protocol: a reader either sees the old blob or the new one, never a torn
write.  ``load_json_versioned`` / ``file_version`` add the reload-on-change
read path the multi-process serving stack uses — each worker remembers the
``(mtime_ns, size, ino)`` stamp of the blob it last loaded and re-reads only
when the stamp moves, so polling shared state costs one ``stat`` per check.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Optional, Tuple

# (mtime_ns, size, inode) — inode included because os.replace swaps the file
# in, so every atomic dump lands on a fresh inode even if mtime granularity
# or an equal size would otherwise hide the change
FileVersion = Tuple[int, int, int]


def load_json(path: str):
    """Read a JSON blob written by ``atomic_json_dump`` (or by hand)."""
    with open(path) as f:
        return json.load(f)


def file_version(path: str) -> Optional[FileVersion]:
    """Change stamp for ``path`` (None when the file does not exist)."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size, st.st_ino)


def load_json_versioned(path: str, seen: Optional[FileVersion]):
    """Reload-on-change read: returns ``(blob, version)`` when the file's
    stamp differs from ``seen``, else ``(None, seen)``.

    Readers race with ``os.replace`` writers: the file can be swapped between
    the ``stat`` and the ``open``.  The open then reads the NEWER complete
    blob (replace is atomic — there is no torn state), so we re-stat after a
    successful read and keep the post-read stamp; at worst the next check
    reloads once more.  A reader can also lose the race terminally (file
    momentarily gone under exotic filesystems) — surfaced as "no change".
    """
    ver = file_version(path)
    if ver is None or ver == seen:
        return None, seen
    try:
        blob = load_json(path)
    except (OSError, json.JSONDecodeError):
        # swapped mid-read or not yet visible — report no change; the next
        # poll sees the settled file
        return None, seen
    after = file_version(path)
    return blob, (after if after is not None else ver)


def atomic_json_dump(path: str, blob) -> None:
    """Write JSON via a same-directory temp file + ``os.replace`` so a crash
    mid-dump can never truncate the target (monitor DB, calibration file)."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(blob, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
