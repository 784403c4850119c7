"""Small constant tensors made once per (value, type, device).

A pass that needs a short table on the card (a light position, a default
texel, an image size) would otherwise copy a Python list to the device at
every call: a copy from pageable memory, which waits for the stream, and
which a CUDA graph cannot capture. constant() makes each such tensor once,
at its first request, and hands the same tensor back after that. The cache
is tracked by the registry, so reload() / clear_caches() empty it; a
captured frame (core/aot.py) holds the addresses of the tensors it read,
and clear_caches() drops those graphs in the same call. The cache is not
bounded: an evicted tensor would be freed under a graph still reading it.

Callers must not write into a returned tensor.
"""

from __future__ import annotations

import functools

import torch

from vkr_ref.core import registry


def _frozen(values):
    """values with every list made a tuple, so that it can key the cache."""
    if isinstance(values, (list, tuple)):
        return tuple(_frozen(v) for v in values)
    return values


@registry.track_cache
@functools.lru_cache(maxsize=None)
def _constant(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """values (a number, or nested lists or tuples of numbers) as a tensor
    of `dtype` on `device`, made at the first request and shared after."""
    return _constant(_frozen(values), dtype, torch.device(device))
