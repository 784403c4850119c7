"""The frozen reference launches no CUDA kernel: every wrapper of the copy
takes its plain PyTorch version on every device. This stub stands where
the program's kernel loader stood, so that the copied wrappers import."""

from __future__ import annotations

import collections

LAUNCHES: collections.Counter = collections.Counter()
_loaded: dict = {}


def library(name: str):
    raise RuntimeError(f"the frozen reference launches no kernel ({name})")


def check(err: int, what: str) -> None:
    raise RuntimeError(f"the frozen reference launches no kernel ({what})")
