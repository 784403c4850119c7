"""Device choice, the port's counterpart of vkr_tpu/core/platform.py.

Every tool calls ensure_platform() first. vkr_tpu pins a jax backend; the
port returns the torch.device its frames run on.
"""

from __future__ import annotations

import hashlib
import os

import torch

_NAMES = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def host_fingerprint() -> str:
    """Short digest of this host's CPU feature set (vkr_tpu keys its
    host-local compile caches by it: code built for one machine's features
    can fault on another)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = line
                    break
            else:
                feats = ""
    except OSError:
        import platform as _p

        feats = _p.processor() + _p.machine()
    return "_" + hashlib.sha1(feats.encode()).hexdigest()[:8]


def ensure_platform(platform: str | None = None) -> torch.device:
    """The device the frames run on. Resolution order: the argument, then
    VKR_PLATFORM (cpu, cuda or gpu), then cuda. Asking for cuda without a
    card raises: nothing carries on on the CPU unasked."""
    want = platform or os.environ.get("VKR_PLATFORM") or "cuda"
    kind = _NAMES.get(want.lower())
    if kind is None:
        raise ValueError(f"unknown platform {want!r}: expected one of "
                         f"{sorted(_NAMES)}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available (torch.cuda.is_available() is "
            "False); set VKR_PLATFORM=cpu to run on the CPU")
    return torch.device(kind)
