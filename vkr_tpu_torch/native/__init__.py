"""ctypes bindings for the port's native asset pipeline (asset_pipeline.cpp).

The library is built at first use with the host compiler ($CXX, else c++)
under vkr_tpu's Makefile flags into build/libvkr_native-<hash>.so, the
hash covering the source, the flags and the host's CPU features
(-march=native code built on one machine can fault on another). A failed
build raises with the compiler's output; nothing falls back. The numpy
plain versions of the image entry points, scene.build_mip_pyramid_plain
and scene._resize_rgba_plain, are their specs. expand_triangles keeps its
argtypes for the ABI but has no wrapper, as in vkr_tpu.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from vkr_tpu_torch.core.platform import host_fingerprint

SOURCE = Path(__file__).resolve().parent / "asset_pipeline.cpp"
BUILD = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native",
             "-shared")
ABI_VERSION = 1

_lib = None


def library_path() -> Path:
    key = (SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
           + host_fingerprint().encode())
    digest = hashlib.blake2b(key, digest_size=8).hexdigest()
    return BUILD / f"libvkr_native-{digest}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX") or "c++", *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native asset pipeline: cannot run {cmd[0]}: "
                           f"{e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"native asset pipeline: {' '.join(cmd)} failed "
            f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.vkr_native_abi_version.restype = ctypes.c_int32
    version = lib.vkr_native_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"native asset pipeline: ABI version {version}, "
                           f"expected {ABI_VERSION}")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    lib.mip_downsample_rgba8.argtypes = [u8p, u8p, i64, i64]
    lib.resize_rgba8.argtypes = [u8p, i64, i64, u8p, i64, i64]
    lib.expand_triangles.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), i64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.transform_points.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        i64, ctypes.POINTER(ctypes.c_float),
    ]
    for fn in ("mip_downsample_rgba8", "resize_rgba8", "expand_triangles",
               "transform_points"):
        getattr(lib, fn).restype = None
    _lib = lib
    return _lib


def available() -> bool:
    """True when the library builds and loads here (vkr_tpu's
    native.available(): True when its prebuilt library loads)."""
    try:
        load()
    except (OSError, RuntimeError):
        return False
    return True


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def mip_downsample_rgba8(src: np.ndarray) -> np.ndarray:
    """(n, s, s, 4) u8 -> (n, s/2, s/2, 4) u8 box filter, (sum + 2) / 4."""
    lib = load()
    src = np.ascontiguousarray(src, np.uint8)
    n, s = src.shape[0], src.shape[1]
    dst = np.empty((n, s // 2, s // 2, 4), np.uint8)
    lib.mip_downsample_rgba8(_ptr(src, ctypes.c_uint8),
                             _ptr(dst, ctypes.c_uint8), n, s)
    return dst


def resize_rgba8(src: np.ndarray, h2: int, w2: int) -> np.ndarray:
    """Bilinear (H, W, 4) u8 -> (h2, w2, 4) u8: half-texel centres, clamp
    to edge."""
    lib = load()
    src = np.ascontiguousarray(src, np.uint8)
    h, w = src.shape[:2]
    dst = np.empty((h2, w2, 4), np.uint8)
    lib.resize_rgba8(_ptr(src, ctypes.c_uint8), h, w,
                     _ptr(dst, ctypes.c_uint8), h2, w2)
    return dst


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(V, 3) f32 points through the row-major 4x4 m (w = 1)."""
    lib = load()
    m = np.ascontiguousarray(m, np.float32)
    pts = np.ascontiguousarray(pts, np.float32)
    dst = np.empty_like(pts)
    lib.transform_points(_ptr(m, ctypes.c_float), _ptr(pts, ctypes.c_float),
                         len(pts), _ptr(dst, ctypes.c_float))
    return dst


def fma32(a, b, c):
    """float32 fma(a, b, c), rounded once: a*b is exact in float64, the
    sum is rounded to odd there (its error from TwoSum), and odd rounding
    to 53 bits then nearest to 24 rounds as one rounding would."""
    p = np.asarray(a).astype(np.float64) * np.asarray(b).astype(np.float64)
    c = np.asarray(c).astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)
