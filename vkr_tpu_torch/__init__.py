"""vkr_tpu_torch — the PyTorch + CUDA port of vkr_tpu for one NVIDIA H100.

Mirrors vkr_tpu's module layout and names, so each module's counterpart is
easy to find. Plain tensor code is PyTorch; every Pallas kernel of the
ported path is a hand-written CUDA C++ kernel under csrc/, built with nvcc
at first use (kernels.py) and bound with ctypes. Each kernel's wrapper
keeps a plain PyTorch version beside it: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.

This package never imports jax or vkr_tpu.

  config.py   — RenderConfig dataclasses (JSON-compatible with vkr_tpu)
  mathlib/    — camera matrices, projection, octahedral normals, BRDF
  core/       — storage-format emulation, FrameState, and the runtime
                layer: the pass registry under the reference's manifest
                names with hot reload (registry.py), the pass graph with
                task labels and DAG dump, and the trace: spans and
                counters, pass spans inside a replay (graph.py),
                readback and PNG / depth-CSV capture (readback.py),
                FrameState checkpoints (checkpoint.py), the start-up
                disk cache (diskcache.py) and the device choice
                (platform.py)
  native/     — the asset pipeline's C++ library (mips, resize), built
                with the host compiler at first use, and its ctypes
                loader
  scene/      — the glTF loader and its PNG decoder, CompiledScene and
                load_scene (uniform or native-size textures), the
                procedural scenes, the fly camera (camera.py), the
                uniform-grid acceleration structure (accel.py)
  raster/     — raster front ends (corner tables, indexed), pair rows, the
                G-buffer kernel (K1), the oracle raster and its gather
                resolve, texture packing and sampling, the window-gather
                kernels (K4/K5/K6)
  passes/     — G-buffer, hi-Z, SSR, GTAO (ray-traced GTAO and the
                variants too), SSAO, deferred shading, TAA, BRDF LUT,
                shadow maps, probe GI, and the passes no frame calls:
                screen trace, simple SSR, the SSR tile path, the util
                passes and the fetch heatmap (trace_samples.py); importing
                the package registers every pass
  frame.py    — render_frame: the frame chain through the registry under
                add_task, and its history remaps; Tuning (the viewer's
                sliders) and the oracle frame (use_kernels=False)
  tools/      — the user entry points: render, parity, profile,
                scene_info, viewer, showcase
  convert.py  — carry vkr_tpu's numpy scene / FrameState / probe grid /
                scene grid arrays across
"""

__version__ = "0.1.0"

from vkr_tpu_torch import core  # noqa: F401,E402
