"""Live interactive viewer — the reference's windowed frame loop
(main.cpp:311-429) for a headless host, as vkr_tpu/tools/viewer.py has it.

There is no display server in the deployment environment, so the "window"
is a browser page served by a tiny built-in HTTP server: the render loop
renders frames on the card, on the main thread; the server runs on a
daemon thread and only copies bytes under the lock (it never touches the
card). The page shows frames as they finish and captures input. Controls
mirror the reference app:

  WASD / QE   fly camera (camera.hpp:91-93)
  arrow keys  look (mouse-look analog, camera.hpp:79-85)
  1           AO-only debug view (defered_shading.cpp:120-126)
  2 / 3 / 4   toggle SSR / GTAO / TAA
  j           toggle TAA jitter (main.cpp:358)
  r           hot-reload pass modules (gpu::reload_shaders analog,
              main.cpp:319-321 -> core.registry.reload)

plus the reference's ImGui tuning panels (GTAO gtao.cpp:528-535, SSSR
advanced_ssr.cpp:556-566, Shading defered_shading.cpp:120-126): sliders
map to `frame.Tuning`, read by the next frame with no new frame function,
like the reference's push-constant update; checkboxes change RenderConfig
and take another frame function, cached per combination, like the
reference's specialization constants.

As vkr_tpu jits one frame per combination with Tuning as a traced
argument (vkr_tpu/tools/viewer.py:290-322), each combination's frame goes
through core/aot.py's cached_jit: captured as CUDA graphs at its first
frame (the FrameState donated), replayed after, dropped by hot reload.
The viewer keeps the MAX_CAPTURES combinations used last (capture_for);
a replay that dropped bin pairs, as a camera flown into a denser view
makes it, is captured anew at the current view
(core/aot.py:call_or_recapture), where vkr_tpu's viewer renders on.
The sliders reach it as five 0-d tensors on the device, which a replay
copies into the graphs' buffers, so moving one needs no new capture.

Usage:
    python -m vkr_tpu_torch.tools.viewer --scene colonnade --width 960 \
        --height 544 --port 8799
Then open http://localhost:8799/ .
"""

from __future__ import annotations

import argparse
import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>vkr_tpu_torch viewer</title><style>
body { background:#111; color:#ccc; font-family:monospace; margin:12px }
img { image-rendering:pixelated; border:1px solid #333 }
#hud { margin:6px 0; white-space:pre }
#panels { display:flex; gap:18px; margin-top:8px }
fieldset { border:1px solid #333; min-width:240px }
label { display:block; margin:2px 0 }
input[type=range] { width:110px; vertical-align:middle }
</style></head><body>
<div id="hud">connecting...</div>
<img id="view" width="%W%" height="%H%">
<div>WASD/QE move &middot; arrows look &middot; 1 AO-only &middot;
2 SSR &middot; 3 GTAO &middot; 4 TAA &middot; j jitter &middot; r reload
(click the page first)</div>
<div id="panels">
<fieldset><legend>GTAO</legend>
<label><input type=checkbox data-t=mis checked> Enable MIS</label>
<label><input type=checkbox data-t=two_dirs> Use 2 directions</label>
<label><input type=checkbox data-t=refl_only> Only reflections ao</label>
<label><input type=range data-s=weight_ratio min=1 max=5 step=0.05
 value=1> Weight ratio <span id=v_weight_ratio>1.00</span></label>
<label><button id=clearhist type=button>Clear history</button></label>
</fieldset>
<fieldset><legend>SSSR</legend>
<label><input type=range data-s=ssr_max_roughness min=0 max=1 step=0.01
 value=1> Max Roughness <span id=v_ssr_max_roughness>1.00</span></label>
<label><input type=range data-s=ssr_temporal_rays min=1 max=128 step=1
 value=16> Temporal rays <span id=v_ssr_temporal_rays>16</span></label>
<label><input type=checkbox data-t=normalize checked> Enable
 normalization</label>
<label><input type=checkbox data-t=accumulate checked> Enable
 accumulation</label>
<label><input type=checkbox data-t=random checked> Enable random
 rays</label>
<label><input type=checkbox data-t=blur checked> Enable blur</label>
<label><input type=checkbox data-t=bilateral checked> Enable bilateral
 filter</label>
</fieldset>
<fieldset><legend>Shading</legend>
<label><input type=range data-s=shade_min_roughness min=0 max=1
 step=0.01 value=0> Min Roughness <span
 id=v_shade_min_roughness>0.00</span></label>
<label><input type=range data-s=shade_max_roughness min=0 max=1
 step=0.01 value=1> Max Roughness <span
 id=v_shade_max_roughness>1.00</span></label>
</fieldset>
</div>
<script>
const keys = {};
onkeydown = e => {
  if (e.target.tagName === "INPUT" || e.target.tagName === "BUTTON")
    return;
  keys[e.key.toLowerCase()] = 1;
  if ("1234jr".includes(e.key)) send({toggle: e.key}); };
onkeyup = e => { keys[e.key.toLowerCase()] = 0; };
function send(extra) {
  const body = Object.assign({keys: Object.keys(keys).filter(k=>keys[k])},
                             extra || {});
  fetch("/input", {method: "POST", body: JSON.stringify(body)});
}
setInterval(send, 50);
document.querySelectorAll("[data-s]").forEach(el => {
  el.oninput = () => {
    document.getElementById("v_" + el.dataset.s).textContent =
      (+el.value).toFixed(2);
    send({slider: {[el.dataset.s]: +el.value}});
  };
});
document.querySelectorAll("[data-t]").forEach(el => {
  el.onchange = () => send({check: {[el.dataset.t]: el.checked}});
});
document.getElementById("clearhist").onclick =
  () => send({clear_history: 1});
let n = 0;
async function poll() {
  while (true) {
    try {
      const r = await fetch("/frame.png?since=" + n);
      n = parseInt(r.headers.get("X-Frame") || "0");
      const blob = await r.blob();
      const img = document.getElementById("view");
      const old = img.src;
      img.src = URL.createObjectURL(blob);
      if (old.startsWith("blob:")) URL.revokeObjectURL(old);
      const s = await (await fetch("/stats")).json();
      document.getElementById("hud").textContent =
        `frame ${s.frame}  ${s.ms.toFixed(1)} ms/frame  ` +
        `ssr:${s.ssr?1:0} gtao:${s.gtao?1:0} taa:${s.taa?1:0} ` +
        `jitter:${s.jitter?1:0} ao-only:${s.ao_only?1:0}`;
    } catch (e) { await new Promise(r => setTimeout(r, 500)); }
  }
}
poll();
</script></body></html>"""


# the checkboxes and keys that change RenderConfig: one frame function each
CONFIG_TOGGLES = ("ssr", "gtao", "taa", "ao_only", "mis", "two_dirs",
                  "refl_only", "normalize", "accumulate", "bilateral",
                  "random", "blur")
# captured frames kept, one per toggle combination used (each holds its
# graphs' pools, ~0.8 GB at 960x544)
MAX_CAPTURES = 8


def capture_for(frames, key, make):
    """frames[key] (an OrderedDict, least recently used first), made by
    make() where it is missing, now the most recently used. Before a new
    one is made, the least recently used beyond MAX_CAPTURES - 1 are
    dropped with their cache_clear(), which frees their graphs' pools."""
    fn = frames.pop(key, None)
    if fn is None:
        while len(frames) >= MAX_CAPTURES:
            _, old = frames.popitem(last=False)
            clear = getattr(old, "cache_clear", None)
            if clear is not None:
                clear()
        fn = make()
    frames[key] = fn
    return fn


def tuning_tensors(sliders, device):
    """The sliders as a frame.Tuning of five 0-d tensors on `device` (the
    four floats float32, the temporal ray count int32, at least 1), each
    made by a fill on the device: no copy from the host, no wait."""
    import torch

    from vkr_tpu_torch.frame import Tuning

    def full(v, dtype=torch.float32):
        return torch.full((), v, dtype=dtype, device=device)

    return Tuning(
        weight_ratio=full(float(sliders["weight_ratio"])),
        ssr_max_roughness=full(float(sliders["ssr_max_roughness"])),
        shade_min_roughness=full(float(sliders["shade_min_roughness"])),
        shade_max_roughness=full(float(sliders["shade_max_roughness"])),
        ssr_temporal_rays=full(max(1, int(sliders["ssr_temporal_rays"])),
                               torch.int32))


class ViewerState:
    """What the HTTP thread and the render loop share, under `lock`: the
    input (keys, toggles, sliders, requests) and the last frame's PNG."""

    def __init__(self):
        self.lock = threading.Lock()
        self.keys = set()
        self.keys_time = 0.0  # keys expire if the client stops posting
        self.toggles = dict(ssr=True, gtao=True, taa=True, jitter=True,
                            ao_only=False,
                            # reference ImGui checkboxes (RenderConfig: a
                            # frame function per combination)
                            mis=True, two_dirs=False, refl_only=False,
                            normalize=True, accumulate=True,
                            random=True, blur=True, bilateral=True)
        # reference ImGui sliders (frame.Tuning, per frame)
        self.sliders = dict(weight_ratio=1.0, ssr_max_roughness=1.0,
                            shade_min_roughness=0.0,
                            shade_max_roughness=1.0,
                            ssr_temporal_rays=16)
        self.clear_history = False
        self.reload_requested = False
        self.png = b""
        self.frame = 0
        self.ms = 0.0
        self.quit = False


def _make_handler(state: ViewerState, width: int, height: int):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, ctype, body, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                since = 0
                if "since=" in self.path:
                    since = int(self.path.split("since=")[1])
                deadline = time.time() + 5.0
                while (state.frame <= since and not state.quit
                       and time.time() < deadline):
                    time.sleep(0.01)
                with state.lock:
                    png, n = state.png, state.frame
                self._send(200, "image/png", png,
                           [("X-Frame", str(n)),
                            ("Cache-Control", "no-store")])
            elif self.path.startswith("/stats"):
                with state.lock:
                    body = json.dumps(dict(
                        frame=state.frame, ms=state.ms, **state.toggles
                    )).encode()
                self._send(200, "application/json", body)
            else:
                page = (_PAGE.replace("%W%", str(width))
                        .replace("%H%", str(height))).encode()
                self._send(200, "text/html", page)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            msg = json.loads(self.rfile.read(n) or b"{}")
            with state.lock:
                state.keys = set(msg.get("keys", []))
                state.keys_time = time.time()
                t = msg.get("toggle")
                if t == "1":
                    state.toggles["ao_only"] ^= True
                elif t == "2":
                    state.toggles["ssr"] ^= True
                elif t == "3":
                    state.toggles["gtao"] ^= True
                elif t == "4":
                    state.toggles["taa"] ^= True
                elif t == "j":
                    state.toggles["jitter"] ^= True
                elif t == "r":
                    state.reload_requested = True
                for k, v in (msg.get("slider") or {}).items():
                    if k in state.sliders:
                        state.sliders[k] = float(v)
                for k, v in (msg.get("check") or {}).items():
                    if k in state.toggles:
                        state.toggles[k] = bool(v)
                if msg.get("clear_history"):
                    state.clear_history = True
            self._send(200, "application/json", b"{}")

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene", default="colonnade")
    parser.add_argument("--width", type=int, default=960)
    parser.add_argument("--height", type=int, default=544)
    parser.add_argument("--tex-size", type=int, default=256)
    parser.add_argument("--lut-size", type=int, default=256)
    parser.add_argument("--columns", type=int, default=8)
    parser.add_argument("--port", type=int, default=8799)
    parser.add_argument("--max-frames", type=int, default=0,
                        help="exit after N frames (0 = run forever)")
    args = parser.parse_args(argv)

    from vkr_tpu_torch.core.platform import ensure_platform

    device = ensure_platform()
    print("backend:", device)
    import dataclasses

    from vkr_tpu_torch import frame as F
    from vkr_tpu_torch.config import RenderConfig
    from vkr_tpu_torch.core import registry
    from vkr_tpu_torch.core.aot import cached_jit, call_or_recapture
    from vkr_tpu_torch.core.formats import linear_to_srgb
    from vkr_tpu_torch.core.framestate import FrameState
    from vkr_tpu_torch.core.readback import png_bytes, to_host
    from vkr_tpu_torch.passes.gbuffer import upload_scene
    from vkr_tpu_torch.scene.camera import Camera
    from vkr_tpu_torch.tools.render import load_preset

    scene_cpu, preset = load_preset(args.scene, args.tex_size,
                                    columns=args.columns)
    scene = upload_scene(scene_cpu, device)
    ssr_res = F.build_ssr_resources(args.lut_size, device=device)

    eye = np.asarray(preset["eye"], np.float32)
    center = np.asarray(preset["center"], np.float32)
    fwd = center - eye
    cam = Camera(position=eye,
                 yaw=float(np.degrees(np.arctan2(fwd[2], fwd[0]))),
                 pitch=float(np.degrees(np.arctan2(
                     fwd[1], np.linalg.norm(fwd[[0, 2]])))))
    cam.speed = float(np.linalg.norm(fwd)) * 0.5

    state = ViewerState()
    server = ThreadingHTTPServer(
        ("0.0.0.0", args.port), _make_handler(state, args.width,
                                              args.height))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"viewer: http://localhost:{args.port}/", flush=True)

    # CONFIG_TOGGLES values -> the captured frame, least recently used first
    frame_fns = collections.OrderedDict()

    def config(tg):
        cfg = RenderConfig(
            width=args.width, height=args.height,
            enable_ssr=tg["ssr"], enable_gtao=tg["gtao"],
            enable_taa=tg["taa"], show_ao_only=tg["ao_only"],
        )
        return dataclasses.replace(
            cfg,
            gtao=dataclasses.replace(
                cfg.gtao, mis=tg["mis"], two_directions=tg["two_dirs"],
                reflections_only=tg["refl_only"]),
            ssr=dataclasses.replace(
                cfg.ssr, normalize_filter=tg["normalize"],
                accumulate=tg["accumulate"],
                bilateral_filter=tg["bilateral"],
                update_random=tg["random"], use_blur=tg["blur"]),
        )

    def frame_fn(cfg):
        return lambda s, st, c, t: F.render_frame(s, st, c, ssr_res, cfg,
                                                  tuning=t)

    fstate = FrameState.initial(args.height, args.width, device)
    prev_view = cam.view_matrix()
    i = 0
    frame_ms = []
    last = time.time()
    while not state.quit:
        with state.lock:
            keys = set(state.keys)
            if time.time() - state.keys_time > 0.5:
                keys = set()  # stale input: client stopped posting
            toggles = dict(state.toggles)
            sliders = dict(state.sliders)
            do_reload = state.reload_requested
            state.reload_requested = False
            do_clear = state.clear_history
            state.clear_history = False
        if do_clear:
            # GTAO "Clear history" button (gtao.cpp:534): restart
            # temporal accumulation from scratch
            fstate = FrameState.initial(args.height, args.width, device)
        if do_reload:
            mods = registry.reload()
            frame_fns.clear()
            print(f"hot reload: {len(mods)} modules, frame functions "
                  "dropped", flush=True)

        now = time.time()
        dt = min(now - last, 0.1)
        last = now
        cam.move(dt,
                 forward=("w" in keys) - ("s" in keys),
                 strafe=("d" in keys) - ("a" in keys),
                 up=("e" in keys) - ("q" in keys))
        look = 120.0 * dt
        cam.rotate(("arrowleft" in keys) * look
                   - ("arrowright" in keys) * look,
                   ("arrowdown" in keys) * look
                   - ("arrowup" in keys) * look)

        key = tuple(toggles[k] for k in CONFIG_TOGGLES)
        cfg = config(toggles)
        view = cam.view_matrix()
        cframe = F.camera_frame(cfg, view, prev_view, i, device,
                                use_jitter=toggles["jitter"])
        tun = tuning_tensors(sliders, device)
        frame = capture_for(frame_fns, key, lambda: cached_jit(
            f"viewer {key}", frame_fn(cfg), (scene, fstate, cframe, tun),
            donate_argnums=(1,)))
        t0 = time.perf_counter()
        color, fstate, _ = call_or_recapture(frame, scene, fstate, cframe,
                                             tun)
        rgb = np.clip(to_host(linear_to_srgb(color)) * 255, 0,
                      255).astype(np.uint8)
        ms = (time.perf_counter() - t0) * 1e3
        frame_ms.append(ms)
        png = png_bytes(rgb, colour_type=2, level=1)
        prev_view = view
        i += 1
        with state.lock:
            state.png = png
            state.frame = i
            state.ms = ms
        if args.max_frames and i >= args.max_frames:
            state.quit = True
    server.shutdown()
    server.server_close()
    print(f"viewer: exit after {i} frames ({state.ms:.1f} ms last, median "
          f"{float(np.median(frame_ms)):.2f} ms/frame)", flush=True)
    return frame_ms


if __name__ == "__main__":
    main()
