"""The frozen reference keeps nothing on disk: cached_npz builds anew on
every call, so that no product of an earlier run (the program's or the
reference's) reaches a comparison."""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def cached_npz(key: str, build: Callable[[], Dict[str, np.ndarray]]):
    del key
    return build()
