"""The gap between the oracle raster (brute force, gather resolve) and the
kernel raster (K1: binned walk, plane resolve), in the port and in vkr_tpu,
on the 24-column hall at 256x128 (bench orbit frame 2, one masked layer).

The oracle rounds its attributes differently (barycentrics against K1's
resolve planes), which moves a unorm8 albedo step or a unorm16 normal step
on a few percent of the pixels, and picks another surface on knife-edge
pixels. vkr_tpu's own pair differs the same way, and also in depth on
most pixels: its oracle's compiled loop contracts the depth plane
differently from its Pallas kernel. Both pairs leave the normals below the
40 dB bar, so the frame tests shade K1's G-buffer, never the oracle's.
vkr_tpu's side runs eagerly, its Pallas kernel interpreted (most of this
file's time)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

W, H = 256, 128
CHANNELS = ["albedo", "normal", "material", "velocity", "depth"]


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


@pytest.fixture(scope="module")
def pairs():
    """{side: (oracle G-buffer, kernel G-buffer)} as numpy arrays."""
    from vkr_tpu.config import RenderConfig
    from vkr_tpu.frame import camera_frame
    from vkr_tpu.passes.gbuffer import render_gbuffer as j_render
    from vkr_tpu.passes.gbuffer import upload_scene as j_upload
    from vkr_tpu.scene.procedural import colonnade_scene
    from vkr_tpu_torch.convert import scene_from_numpy
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    scene_np = colonnade_scene(columns=24, tessellation=4, tex_size=32)
    cam = camera_frame(RenderConfig(width=W, height=H), bench_orbit_view(2),
                       bench_orbit_view(1), 2)
    kw = dict(width=W, height=H, quantize=True, mask_peel_layers=1)
    jscene = j_upload(scene_np)
    jside = [j_render(jscene, cam.mvp, cam.prev_mvp, cam.jitter,
                      use_pallas=p, interpret=p, **kw) for p in (False, True)]
    scene = scene_from_numpy(scene_np, "cpu")
    args = [torch.from_numpy(np.array(a)) for a in
            (cam.mvp, cam.prev_mvp, cam.jitter)]
    tside = [render_gbuffer(scene, *args, oracle=o, **kw)
             for o in (True, False)]

    def arrays(g):
        return {c: np.asarray(getattr(g, c)) for c in CHANNELS}

    return {"vkr_tpu": [arrays(g) for g in jside],
            "port": [arrays(g) for g in tside]}


def _differ(a, b):
    return (a != b).reshape(H, W, -1).any(-1).mean()


@pytest.mark.parametrize("channel", CHANNELS)
def test_gap_per_channel(pairs, channel):
    """The port's oracle/K1 pair differs on a share of the pixels no larger
    than vkr_tpu's own pair's (2% above it at most) and is within 0.5 dB
    of it or closer (measured here: albedo 0.0285 of the pixels, 41.37 dB,
    against vkr_tpu's 0.0309, 41.36 dB; normal 0.0067, 38.21 dB against
    0.0084, 34.77 dB)."""
    stats = {}
    for side, (oracle, kernel) in pairs.items():
        stats[side] = (_differ(oracle[channel], kernel[channel]),
                       psnr(oracle[channel], kernel[channel]))
        print(f"{channel} {side}: oracle vs kernel raster differ on "
              f"{stats[side][0]:.4f} of the pixels, {stats[side][1]:.2f} dB")
    (port_share, port_db), (j_share, j_db) = stats["port"], stats["vkr_tpu"]
    assert port_share <= j_share * 1.02 + 1e-4
    assert port_db >= j_db - 0.5
    # the K1 G-buffers themselves agree far above the bar
    assert psnr(pairs["port"][1][channel],
                pairs["vkr_tpu"][1][channel]) >= 100.0


def test_gap_is_open(pairs):
    """The open gap ROADMAP queue 3 records: on both sides the oracle's
    normals stay below 40 dB against the kernel raster's; the port's two
    rasters pick the same surface (equal depth) on >= 0.998 of the
    pixels."""
    for side in ("port", "vkr_tpu"):
        oracle, kernel = pairs[side]
        assert psnr(oracle["normal"], kernel["normal"]) < 40.0, side
    oracle, kernel = pairs["port"]
    same = (oracle["depth"] == kernel["depth"]).mean()
    print(f"port: depth equal on {same:.6f} of the pixels")
    assert same >= 0.998
