"""The reference renderer's glTF assets, which this repository does not
hold: the Suzanne and Fox presets and the Sponza texture set read them
from the directory that VKR_ASSETS names (the reference's assets/gltf),
resolved when they are loaded."""

from __future__ import annotations

import os

ASSETS_ENV = "VKR_ASSETS"


def asset_path(asset: str, name: str) -> str:
    """The path of a reference asset under $VKR_ASSETS; raises
    FileNotFoundError naming VKR_ASSETS when it is unset, or naming the
    path when the file is not there. name is the scene that reads it."""
    root = os.environ.get(ASSETS_ENV)
    if not root:
        raise FileNotFoundError(
            f"scene {name!r} reads {asset} from the reference renderer's "
            f"glTF assets: set {ASSETS_ENV} to its assets/gltf directory, "
            "or use the colonnade scene")
    path = os.path.join(root, asset)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"scene {name!r} reads {path}, which is not there; set "
            f"{ASSETS_ENV} to the reference renderer's assets/gltf "
            "directory, or use the colonnade scene")
    return path
