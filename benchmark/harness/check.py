"""What decides `correct`: frames of the window, kept as the timed path
produced them, against the frozen plain frame and the independent
image-space chain (benchmark/reference).

Which frames. The capture frame (frame 0), which the reference renders
from its own initial state: the start. Then `checked_pairs` pairs of
consecutive window frames (i, i + 1), i drawn from the seed: the
reference renders frame i from the state the program carried into it
(the reference cannot replay hundreds of frames inside the run), and
frame i + 1 from the state its own frame i left, so the carry from one
frame to the next is checked on the reference's side too.

What is compared, frame by frame, as one number per group (the largest
over the checked frames): the relative L2 gap |p - r| / |r| of each
tensor, the largest in its group.
  colour    the final colour
  gbuffer   aux's G-buffer planes: albedo, normal, material, velocity,
            depth
  ssr, ao   aux's blurred SSR and accumulated AO
  state     every FrameState field the frame returns: TAA history, GTAO
            accumulation and previous AO, SSR history, previous depth
            and its half-res mip, previous view-projection, frame index
  overflow  the bin pairs dropped, exactly (with probe GI also by the
            probe grid's cube faces)
  probe     with probe GI: the probe grid's colours and packed depth
            pyramids (frame 0), and aux's probe image
and against the independent chain (reference/plain_chain.py), which
judges each stage (SSR and GTAO on the frame's own G-buffer, shading and
TAA on the frozen frame's G-buffer, AO and SSR):
  ind_ssr     the blurred SSR and its history, and the half-res depth
              (with probe GI: composed with the frame's probe image)
  ind_ao      the accumulated AO, its history and the previous AO
  ind_colour  the final colour (shading and TAA) and the TAA history
  ind_probe   with probe GI: the probe image, and the SSR image composed
              with it
The limits (LIMITS, PROBE_LIMITS; limits_of) and the readings they were
set from are in PERF.md.

Keeping a frame costs the window a copy to pinned host memory on a side
stream, which runs beside the next frame; the frame after that waits on
the copy on the device, not on the host.
"""

from __future__ import annotations

import math

import numpy as np

GROUPS = ("colour", "gbuffer", "ssr", "ao", "state")
INDEPENDENT = ("ind_ssr", "ind_ao", "ind_colour")
# relative L2 gap per group; the overflow is compared exactly
LIMITS = {"colour": 1e-3, "gbuffer": 1e-3, "ssr": 1e-3, "ao": 1e-3,
          "state": 1e-3, "overflow": 0, "ind_ssr": 1e-3, "ind_ao": 5e-3,
          "ind_colour": 1e-3}
# the probe groups, read only where the configuration has probe GI
PROBE_LIMITS = {"probe": 1e-3, "ind_probe": 1e-3}
STATE_FIELDS = ("prev_depth", "prev_depth_half", "taa_history", "gtao_accum",
                "gtao_prev", "ssr_history", "prev_mvp", "frame_index")
GBUFFER_PLANES = ("albedo", "normal", "material", "velocity", "depth")


def outputs(colour, state, aux) -> dict:
    """The tensors compared, by name, of a frame's (colour, state, aux):
    the program's and the reference's have the same fields."""
    out = {"colour": colour, "ssr": aux["ssr"], "ao": aux["ao"],
           "overflow": aux["overflow"]}
    if aux.get("probe") is not None:
        out["probe"] = aux["probe"]
    for k in GBUFFER_PLANES:
        out[f"gbuffer.{k}"] = getattr(aux["gbuffer"], k)
    for k in STATE_FIELDS:
        out[f"state.{k}"] = getattr(state, k)
    return out


def grid_outputs(grid) -> dict:
    """The probe grid's tensors compared at frame 0, the program's and the
    reference's alike."""
    return {"probe.colors": grid.colors, "probe.depth_flat": grid.depth_flat,
            "overflow.probe_faces": grid.face_overflow}


def limits_of(config: dict) -> dict:
    """The numbers a configuration's cells are held to, with their limits."""
    if config["render"].get("enable_probes"):
        return {**LIMITS, **PROBE_LIMITS}
    return LIMITS


def group(name: str) -> str:
    return name.split(".")[0]


def rel_l2(p, r) -> float:
    import torch

    p = torch.as_tensor(p).double().cpu()
    r = torch.as_tensor(r).double().cpu()
    if p.shape != r.shape:
        return math.inf
    d = float(torch.linalg.vector_norm(p - r))
    n = float(torch.linalg.vector_norm(r))
    return d / n if n > 0 else (0.0 if d == 0 else math.inf)


def compare(prog: dict, ref: dict) -> dict:
    """{group: reading} of one frame."""
    import torch

    out = {g: 0.0 for g in GROUPS}
    for name, r in ref.items():
        g = group(name)
        if g == "overflow":
            gap = int((torch.as_tensor(prog[name]).long().cpu()
                       - torch.as_tensor(r).long().cpu()).abs().sum())
            out["overflow"] = max(out.get("overflow", 0), gap)
        else:
            e = rel_l2(prog[name], r)
            worst_yet = out.get(g, 0.0)
            out[g] = e if not e <= worst_yet else worst_yet
    return out


def compare_groups(prog: dict, expected: dict) -> dict:
    """{group: reading} of one frame against the independent chain's
    {group: {name: tensor}}: the largest relative L2 gap in each group."""
    out = {}
    for g, tensors in expected.items():
        out[g] = 0.0
        for name, r in tensors.items():
            e = rel_l2(prog[name], r)
            out[g] = e if not e <= out[g] else out[g]
    return out


def probe_fill(probe, rays) -> float:
    """The share of the pixels the SSR trace left empty (rays w = 1) that
    a probe hit fills."""
    import torch

    empty = torch.as_tensor(rays)[..., 3].cpu() >= 1.0
    hit = torch.as_tensor(probe)[..., 3].cpu() > 0.5
    return float((empty & hit).sum()) / max(int(empty.sum()), 1)


def worst(readings) -> dict:
    """The largest reading of each number over frames (NaN wins)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if k not in out or not v <= out[k]:
                out[k] = v
    return out


def verdict(readings: dict, limits=LIMITS) -> bool:
    return all(readings.get(k, math.inf) <= lim for k, lim in limits.items())


def checks_line(readings: dict, limits=LIMITS) -> dict:
    """The result line's last key: each number beside its limit."""
    return {k: {"value": readings.get(k, math.inf), "limit": lim}
            for k, lim in limits.items()}


def draw_pairs(seed: int, n_pairs: int, lo: int, hi: int) -> list:
    """n_pairs first frames i of checked pairs (i, i + 1), drawn from the
    seed in [lo, hi), at least two apart, sorted."""
    rng = np.random.default_rng([seed, 1])
    span = max(hi - lo, 2 * n_pairs)
    slots = rng.choice(span // 2, size=n_pairs, replace=False)
    return sorted(lo + 2 * int(s) for s in slots)


class Keeper:
    """Copies of chosen frames' tensors, made without stalling the window:
    on the card each copy goes to pinned host memory reserved in set-up
    (reserve), on a side stream that waits for the frame; a later frame
    that would overwrite the source waits on the copy (on the device). On
    the CPU a copy is a clone."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"
        self.side = torch.cuda.Stream(device) if self.cuda else None
        self.free = {}       # kind -> [buffers]
        self.pending = []    # (event, frame that must wait for it)

    def reserve(self, kind: str, template: dict, n: int):
        """n sets of pinned buffers shaped as template's tensors."""
        if self.cuda:
            self.free[kind] = [
                {k: self.torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
                 for k, t in template.items()} for _ in range(n)]

    def keep(self, kind: str, tensors: dict, before_frame: int) -> dict:
        """A copy of tensors into a reserved set of kind; the frame numbered
        before_frame, and every later one, runs after the copy."""
        torch = self.torch
        if not self.cuda:
            return {k: t.clone() for k, t in tensors.items()}
        dst = self.free[kind].pop()
        self.side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.side):
            for k, t in tensors.items():
                dst[k].copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        self.pending.append((done, before_frame))
        return dst

    def before(self, k: int):
        """Make frame k's stream wait for the copies it would overwrite."""
        if not self.cuda:
            return
        keep = []
        for done, frame in self.pending:
            if frame <= k:
                self.torch.cuda.current_stream().wait_event(done)
            else:
                keep.append((done, frame))
        self.pending = keep

    def finish(self):
        if self.cuda:
            self.side.synchronize()
