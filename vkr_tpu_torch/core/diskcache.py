"""Content-keyed disk cache for expensive start-up artifacts, as
vkr_tpu/core/diskcache.py has it (same layout, same keys for the same
parts, same VKR_DISK_CACHE switch).

The reference pays its start-up cost in stb_image decodes and blocking
staged uploads every run (scene.cpp:330-360, images.cpp:22-55). Start-up
products that are pure functions of their inputs (the SSR LUTs of
frame.build_ssr_resources) are kept on disk as raw .npy files under an
explicit parameter key or a content hash. The port's entries carry keys
of their own (frame.py names the port and the device type in them): both
packages write into one .vkr_cache/, and the port computes its LUTs with
other code, on the card or on the CPU.

Set VKR_DISK_CACHE=0 to disable, or point it at a directory.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict

import numpy as np

# bump when the layout of any cached artifact changes
VERSION = 1


def _cache_dir() -> str | None:
    env = os.environ.get("VKR_DISK_CACHE", "")
    if env == "0":
        return None
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), ".vkr_cache")


def content_key(*parts) -> str:
    """Stable key from a mix of scalars/strings/arrays (arrays are
    hashed by bytes — cheap relative to what the cache avoids)."""
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(str(p.shape).encode())
            h.update(str(p.dtype).encode())
            h.update(np.ascontiguousarray(p).data)
        else:
            h.update(repr(p).encode())
    return h.hexdigest()


def cached_npz(key: str,
               build: Callable[[], Dict[str, np.ndarray]]
               ) -> Dict[str, np.ndarray]:
    """Return build()'s dict of arrays, memoized on disk under key.

    Layout: one raw .npy per array in a per-key directory plus an OK
    marker written last (np.load on a zipfile-backed .npz streams through
    Python at ~30 MB/s; raw .npy reads go at disk speed)."""
    d = _cache_dir()
    if d is None:
        return build()
    ent = os.path.join(d, f"{key}-v{VERSION}")
    marker = os.path.join(ent, "OK")
    if os.path.exists(marker):
        try:
            with open(marker) as f:
                names = [ln.strip() for ln in f if ln.strip()]
            return {n: np.load(os.path.join(ent, n + ".npy"),
                               allow_pickle=False) for n in names}
        except Exception:
            pass  # corrupt/partial entry: rebuild
    out = build()
    try:
        os.makedirs(ent, exist_ok=True)
        for n, a in out.items():
            tmp = os.path.join(ent, f".tmp{os.getpid()}-{n}")
            with open(tmp, "wb") as f:
                np.save(f, np.ascontiguousarray(a))
            os.replace(tmp, os.path.join(ent, n + ".npy"))
        tmp = os.path.join(ent, f".tmpOK{os.getpid()}")
        with open(tmp, "w") as f:
            f.write("\n".join(out.keys()))
        os.replace(tmp, marker)
    except Exception:
        pass  # cache write failure is non-fatal
    return out
