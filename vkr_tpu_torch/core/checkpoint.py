"""FrameState checkpoint/resume, in vkr_tpu/core/checkpoint.py's layout.

The reference serialises no state (its only persistence is debug
captures). As vkr_tpu's extension, the temporal history (FrameState) is
saved and restored so a run's TAA/GTAO/SSR convergence survives a
restart. The file is vkr_tpu's: one compressed .npz with an array per
FrameState.FIELDS name, frame_index a 0-d int32 (in both packages an
int32 array on the device), so checkpoints load in both directions.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vkr_tpu_torch.core.framestate import FrameState
from vkr_tpu_torch.core.readback import to_host

CUDA = torch.device("cuda")


def save_state(state: FrameState, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {name: to_host(getattr(state, name))
              for name in FrameState.FIELDS}
    np.savez_compressed(path, **arrays)
    return path


def load_state(path: str, device=CUDA) -> FrameState:
    """The FrameState saved at `path`, its tensors on `device` (the card
    unless the caller asks for another)."""
    with np.load(path) as data:
        return FrameState(**{
            name: torch.from_numpy(np.array(data[name])).to(device)
            for name in FrameState.FIELDS})
