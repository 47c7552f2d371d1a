"""Disk cache for expensive host-side setup products.

Port of ``fenicsx_beat_tpu/cache.py``: the smoothed-aggregation hierarchy
(:func:`~.ops.amg.build_amg` with ``cache_key``) and the generated LV and
BiV geometries (``cache=True``) are one-shot host computations that cost
seconds to minutes at production sizes; a warm run reads them back from
one npz file.

Every entry is keyed by a sha256 fingerprint over (schema, a caller
string, every option value, and the bytes of every keyed array), so a
stale file is never served for different inputs or after a change of
meaning.  A slot is published atomically (a private temp file, then a
rename).  Any failure (read-only file system, disk full, a concurrent
writer, a torn or foreign file) degrades to a rebuild, never an error.

The directory is ``$XDG_CACHE_HOME/fenicsx_beat_tpu_torch/<kind>``
(``~/.cache`` when ``XDG_CACHE_HOME`` is unset): the port's own, apart
from the JAX package's.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

__all__ = ["SCHEMA", "cache_dir", "fingerprint", "load_arrays", "store_arrays"]

# bump on any change to what cached products mean or contain
SCHEMA = 1


def cache_dir(kind: str) -> Path:
    base = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return Path(base) / "fenicsx_beat_tpu_torch" / kind


def fingerprint(kind: str, parts, arrays=()) -> Path:
    """Cache slot for ``kind`` keyed by scalar ``parts`` (stringified)
    and the raw bytes of ``arrays``."""
    h = hashlib.sha256()
    h.update((f"{SCHEMA}|{kind}|" + "|".join(str(p) for p in parts)).encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a)
    return cache_dir(kind) / f"{h.hexdigest()[:20]}.npz"


def load_arrays(path: Path) -> dict | None:
    """Load an npz slot into a plain dict of numpy arrays (None on a miss
    or any corruption)."""
    if not path.is_file():
        return None
    try:
        with np.load(path, allow_pickle=False) as f:
            return {k: f[k] for k in f.files}
    except Exception:
        return None


def store_arrays(path: Path, arrays: dict) -> None:
    """Atomically publish a dict of numpy arrays to the slot: write a
    private temp file, then rename, so a kill mid-write or a concurrent
    writer never leaves a torn file at the final path."""
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.tmp-{os.getpid()}.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
    except Exception:
        pass
