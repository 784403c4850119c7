"""vkr_tpu_torch's whole G-buffer pass against vkr_tpu's: the masked
colonnade frame through both production paths. The front end, K1's plain
version and the second masked layer are held in test_torch_raster.py."""

import numpy as np
import pytest
import torch


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


@pytest.fixture(scope="module")
def gbuffer_pair():
    """The same masked colonnade frame through vkr_tpu's G-buffer and the
    port's. vkr_tpu runs its production path (the SoA front end and the
    Pallas kernel, interpreted) EAGERLY: under jit XLA would contract the
    front end's mul+add pairs into FMAs differently from the port's
    op-by-op rounding (tests/test_raster.py::TestSoAFrontEnd), moving
    depth by an ulp on most pixels."""
    from vkr_tpu.config import RenderConfig
    from vkr_tpu.frame import camera_frame
    from vkr_tpu.passes.gbuffer import render_gbuffer as j_render
    from vkr_tpu.passes.gbuffer import upload_scene as j_upload
    from vkr_tpu.scene.procedural import colonnade_scene
    from vkr_tpu_torch.convert import scene_from_numpy
    from vkr_tpu_torch.passes.gbuffer import render_gbuffer as t_render
    from vkr_tpu_torch.scene.orbit import bench_orbit_view

    cfg = RenderConfig(width=256, height=128, enable_ssr=False)
    scene_np = colonnade_scene(columns=8, tessellation=8, tex_size=32)
    cam = camera_frame(cfg, bench_orbit_view(2), bench_orbit_view(1), 2)
    kw = dict(width=cfg.width, height=cfg.height, quantize=True,
              mask_peel_layers=2)
    jg = j_render(j_upload(scene_np), cam.mvp, cam.prev_mvp, cam.jitter,
                  use_pallas=True, interpret=True, **kw)
    scene = scene_from_numpy(scene_np, "cpu")
    tg = t_render(scene, *(torch.from_numpy(np.array(a)) for a in
                           (cam.mvp, cam.prev_mvp, cam.jitter)), **kw)
    return scene, cam, jg, tg


class TestRenderGbuffer:
    def test_masked_layer_is_exercised(self, gbuffer_pair):
        from vkr_tpu_torch.passes.gbuffer import corner_transform_t
        from vkr_tpu_torch.raster.pipeline import rasterize

        scene, cam, _, _ = gbuffer_pair
        mvp = torch.from_numpy(np.array(cam.mvp))
        vis = rasterize(corner_transform_t(scene.corner_world_m, mvp),
                        torch.zeros((9, scene.corner_world_m.shape[1])),
                        scene.tri_masked_mat, width=256, height=128,
                        tile_w=512)
        assert (vis.tri_id >= 0).float().mean() > 0.01

    @pytest.mark.parametrize("channel", ["albedo", "normal", "material",
                                         "velocity", "depth"])
    def test_channel_psnr(self, gbuffer_pair, channel):
        _, _, jg, tg = gbuffer_pair
        got = getattr(tg, channel).numpy()
        want = np.asarray(getattr(jg, channel))
        assert got.shape == want.shape
        # the repo's parity bar (BASELINE.json, tools/parity.py)
        assert psnr(got, want) >= 40.0, channel

    def test_depth_equal_on_covered_pixels(self, gbuffer_pair):
        _, _, jg, tg = gbuffer_pair
        got = tg.depth.numpy()
        want = np.asarray(jg.depth)
        covered = (got < 1.0) | (want < 1.0)
        assert covered.mean() > 0.9
        # at most knife-edge coverage flips (1-ulp plane differences)
        assert (got[covered] == want[covered]).mean() >= 0.999
        assert int(tg.overflow) == 0 == int(jg.overflow)
