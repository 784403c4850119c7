#!/usr/bin/env python3
"""Write the committed JPEG textures of chip_smoke.py's JPEG glTF phase.

    python3 tests/torch_images/make_images.py

The eight textures are the bench colonnade's own (chip_smoke.SCENE, as
chip_smoke.gltf_textures sizes them: 1024x1024 REPEAT, and 2048x512 CLAMP
for textures 3, 4 and 7), each encoded by PIL at quality 75 in one of the
forms below, so that across the set the port's JPEG decoder
(vkr_tpu_torch/scene/jpeg.py) meets baseline and progressive scans,
4:2:0, 4:2:2 and 4:4:4 sampling, optimised Huffman tables, restart
markers, greyscale and CMYK. digests.json keeps, per file, its form and
the SHA-256 of PIL's Image.open(...).convert("RGBA") bytes ((H, W, 4)
uint8, C order), which the phase holds the port's decode to.

It also writes four small JPEGs in the samplings PIL cannot write, 4:4:0
and 4:1:1, baseline and progressive, with OpenCV's encoder; the CPU tests
(tests/test_torch_images.py) hold the port's decode of them to PIL's.
Needs PIL and OpenCV; prints each file's size.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
QUALITY = 75
# texture index -> (PIL mode, save options, form)
FORMS = {
    0: ("RGB", dict(subsampling="4:2:0"), "baseline 4:2:0"),
    1: ("RGB", dict(subsampling="4:2:2", progressive=True),
        "progressive 4:2:2"),
    2: ("RGB", dict(subsampling="4:4:4", optimize=True,
                    restart_marker_rows=2),
        "baseline 4:4:4, optimised tables, a restart every 2 MCU rows"),
    3: ("RGB", dict(subsampling="4:2:0", progressive=True),
        "progressive 4:2:0"),
    4: ("RGB", dict(subsampling="4:2:0", restart_marker_blocks=64),
        "baseline 4:2:0, a restart every 64 MCUs"),
    5: ("CMYK", dict(), "CMYK (Adobe APP14), baseline"),
    6: ("L", dict(), "greyscale baseline"),
    7: ("L", dict(progressive=True), "greyscale progressive"),
}


# file -> (OpenCV sampling constant, progressive, height, width)
SAMPLINGS = {
    "sampling_440.jpg": ("IMWRITE_JPEG_SAMPLING_FACTOR_440", 0, 45, 61),
    "sampling_440_progressive.jpg": ("IMWRITE_JPEG_SAMPLING_FACTOR_440", 1,
                                     29, 37),
    "sampling_411.jpg": ("IMWRITE_JPEG_SAMPLING_FACTOR_411", 0, 45, 61),
    "sampling_411_progressive.jpg": ("IMWRITE_JPEG_SAMPLING_FACTOR_411", 1,
                                     29, 37),
}


def file_name(t: int) -> str:
    return f"colonnade_tex{t}.jpg"


def rgba_digest(data: bytes) -> str:
    """SHA-256 of PIL's convert("RGBA") of the image bytes."""
    import numpy as np
    from PIL import Image

    rgba = np.ascontiguousarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    return hashlib.sha256(rgba.tobytes()).hexdigest()


def main() -> int:
    import PIL
    from PIL import Image, features

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import chip_smoke
    from vkr_tpu_torch.scene.procedural import build_colonnade

    src = build_colonnade(**chip_smoke.SCENE)
    images, _ = chip_smoke.gltf_textures(src.images)
    digests = {}
    total = 0
    for t, (mode, options, form) in FORMS.items():
        out = io.BytesIO()
        Image.fromarray(images[t][..., :3]).convert(mode).save(
            out, "JPEG", quality=QUALITY, **options)
        data = out.getvalue()
        with open(os.path.join(HERE, file_name(t)), "wb") as f:
            f.write(data)
        h, w = images[t].shape[:2]
        digests[file_name(t)] = dict(texture=t, form=form, shape=[h, w, 4],
                                     rgba_sha256=rgba_digest(data))
        total += len(data)
        print(f"{file_name(t)}: {w}x{h}, {form}, {len(data)} bytes")
    digests["made_with"] = (f"Pillow {PIL.__version__}, libjpeg-turbo "
                            f"{features.version('libjpeg_turbo')}")
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1)
        f.write("\n")
    print(f"total {total} bytes ({digests['made_with']})")
    write_samplings()
    return 0


def write_samplings() -> None:
    """SAMPLINGS at quality 90, from a seeded image of gradients and
    noise (OpenCV takes BGR; the files hold its YCbCr)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:45, 0:61]
    img = np.stack([128 + 100 * np.sin(x / 5), 128 + 80 * np.cos(y / 7),
                    128 + 60 * np.sin((x + y) / 9)], -1)
    img = np.clip(img + rng.normal(0, 20, img.shape), 0,
                  255).astype(np.uint8)
    for name, (sampling, progressive, h, w) in SAMPLINGS.items():
        ok, data = cv2.imencode(".jpg", img[:h, :w], [
            cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            getattr(cv2, sampling), cv2.IMWRITE_JPEG_PROGRESSIVE,
            progressive])
        if not ok:
            raise RuntimeError(f"OpenCV could not encode {name}")
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data.tobytes())
        print(f"{name}: {w}x{h}, OpenCV {cv2.__version__}, "
              f"{len(data)} bytes")


if __name__ == "__main__":
    sys.exit(main())
