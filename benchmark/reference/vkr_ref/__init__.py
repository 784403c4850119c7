"""The benchmark's plain reference renderer: a frozen copy of the port's
frame code as it stood at commit 19870451 (vkr_tpu_torch's config.py,
frame.py, core/{constants,formats,framestate,graph,registry}.py,
mathlib/, passes/ (probes.py among them: the probe grid's cube faces go
through K1's plain version), raster/ and scene/{accel,assets,gltf,jpeg,
procedural,resample,scene}.py), with the package renamed vkr_ref. It
imports nothing of the program, and a later change to the program does
not move it.

What the copy changes, and nothing else:
  * every kernel wrapper (K1/K7 raster/gbuf_kernel.py and kernel.py, the
    march passes/ssr_march.py, K4/K5/K6 raster/gather_kernel.py, R1
    scene/accel.py) takes its plain PyTorch version on every device: the
    specs the CUDA kernels are held to. kernels.py is a stub that raises.
  * native/ is the asset pipeline's numpy plain version, not the C++
    library; core/diskcache.py builds anew instead of reading a cache.
  * the package and subpackage __init__ files import only what is here.

It runs eagerly, on whatever device its tensors are on, with exact
bin-pair capacities (no captured frame, no static plan).
"""

__version__ = "frozen-19870451"

from vkr_ref import core  # noqa: F401,E402
