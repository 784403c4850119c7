"""vkr_tpu_torch host layer against vkr_tpu: config, scene arrays, mathlib,
storage formats. Inputs come from numpy with fixed seeds; both sides get
the same arrays."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkr_tpu import config as jcfg
from vkr_tpu.core import formats as jformats
from vkr_tpu.mathlib import brdf as jbrdf
from vkr_tpu.mathlib import octahedral as joct
from vkr_tpu.mathlib import projection as jproj
from vkr_tpu.mathlib import transforms as jtf
from vkr_tpu.scene.procedural import colonnade_scene as jcolonnade
from vkr_tpu_torch import config as tcfg
from vkr_tpu_torch.core import formats as tformats
from vkr_tpu_torch.mathlib import brdf as tbrdf
from vkr_tpu_torch.mathlib import octahedral as toct
from vkr_tpu_torch.mathlib import projection as tproj
from vkr_tpu_torch.mathlib import transforms as ttf
from vkr_tpu_torch.scene.orbit import bench_orbit_view
from vkr_tpu_torch.scene.procedural import colonnade_scene as tcolonnade

# float32 elementwise math: both sides round each op, but transcendentals
# (tan, pow, sqrt-based norms) come from different libraries — 1e-6 is a
# few float32 ulps at the unit scale these functions work at.
ATOL = 1e-6


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


class TestConfig:
    def test_json_round_trip_both_ways(self):
        cfg = tcfg.RenderConfig(
            width=640, height=360, enable_ssr=False,
            gtao=tcfg.GTAOConfig(samples=12, two_directions=True),
            raster=tcfg.RasterConfig(mask_peel_layers=1))
        text = cfg.to_json()
        assert tcfg.RenderConfig.from_json(text) == cfg
        # the JSON is the same document vkr_tpu reads and writes
        jc = jcfg.RenderConfig.from_json(text)
        assert jc.to_json() == text
        assert tcfg.RenderConfig.from_json(jcfg.RenderConfig().to_json()) \
            == tcfg.RenderConfig()

    def test_defaults_match(self):
        assert dataclasses.asdict(tcfg.RenderConfig()) == \
            dataclasses.asdict(jcfg.RenderConfig())


class TestScene:
    def test_colonnade_arrays_equal_exactly(self):
        kw = dict(columns=2, tessellation=8, tex_size=32)
        a = jcolonnade(**kw)
        b = tcolonnade(**kw)
        for name in b._fields:
            va, vb = getattr(a, name), getattr(b, name)
            if name == "tex_mips":
                assert len(va) == len(vb)
                for ma, mb in zip(va, vb):
                    np.testing.assert_array_equal(ma, mb)
            else:
                assert np.asarray(va).dtype == np.asarray(vb).dtype, name
                np.testing.assert_array_equal(va, vb, err_msg=name)

    def test_bench_orbit_matches_bench_py(self):
        from bench import bench_orbit_view as j_orbit

        for i in (0, 3, 15):
            np.testing.assert_array_equal(bench_orbit_view(i), j_orbit(i))


class TestMathlib:
    def test_host_matrices_equal(self):
        np.testing.assert_array_equal(
            ttf.look_at((1, 2, 3), (0, 1, -4), (0, -1, 0)),
            jtf.look_at((1, 2, 3), (0, 1, -4), (0, -1, 0)))
        np.testing.assert_array_equal(
            ttf.perspective(1.0, 16 / 9, 0.05, 80.0),
            jtf.perspective(1.0, 16 / 9, 0.05, 80.0))
        np.testing.assert_array_equal(ttf.taa_jitter_sequence(256, 128),
                                      jtf.taa_jitter_sequence(256, 128))
        m = np.random.default_rng(1).random((4, 4)).astype(np.float32) + \
            np.eye(4, dtype=np.float32)
        np.testing.assert_array_equal(ttf.normal_matrix(m),
                                      jtf.normal_matrix(m))

    def test_projection(self):
        rng = np.random.default_rng(2)
        uv = rng.random((64, 2)).astype(np.float32)
        d = rng.uniform(0.5, 0.999, 64).astype(np.float32)
        args = (1.0471976, 16 / 9, 0.05, 80.0)
        want = np.asarray(jproj.reconstruct_view_vec(uv, d, *args))
        got = _np(tproj.reconstruct_view_vec(torch.from_numpy(uv),
                                             torch.from_numpy(d), *args))
        # view z reaches -80: compare relative to magnitude
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=ATOL)
        np.testing.assert_allclose(
            _np(tproj.project_view_vec(torch.from_numpy(want.copy()), *args)),
            np.asarray(jproj.project_view_vec(want, *args)), atol=2e-6)
        np.testing.assert_allclose(
            _np(tproj.linearize_depth(torch.from_numpy(d), 0.05, 80.0)),
            np.asarray(jproj.linearize_depth(d, 0.05, 80.0)),
            rtol=1e-6, atol=ATOL)

    def test_octahedral_round_trip(self):
        rng = np.random.default_rng(3)
        n = rng.normal(size=(256, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        enc = _np(toct.encode_normal(torch.from_numpy(n)))
        np.testing.assert_allclose(enc, np.asarray(joct.encode_normal(n)),
                                   atol=ATOL)
        np.testing.assert_allclose(
            _np(toct.decode_normal(torch.from_numpy(enc))),
            np.asarray(joct.decode_normal(enc)), atol=ATOL)

    def test_brdf_functions(self):
        rng = np.random.default_rng(4)
        c = rng.uniform(-1, 1, 512).astype(np.float32)
        a = rng.uniform(0, 1, 512).astype(np.float32)
        b = rng.uniform(0, 1, 512).astype(np.float32)
        f0 = rng.random((512, 3)).astype(np.float32)
        t = torch.from_numpy
        pairs = [
            (tbrdf.distribution_ggx(t(c), t(a)), jbrdf.distribution_ggx(c, a)),
            (tbrdf.brdf_g1(t(a), t(b)), jbrdf.brdf_g1(a, b)),
            (tbrdf.brdf_g2(t(a), t(b), t(c * c)), jbrdf.brdf_g2(a, b, c * c)),
            (tbrdf.fresnel_schlick(t(a), t(f0)),
             jbrdf.fresnel_schlick(a, f0)),
            (tbrdf.f0_approximation(t(f0), t(a)),
             jbrdf.f0_approximation(f0, a)),
        ]
        for got, want in pairs:
            # the GGX NDF peaks at 1/(pi alpha^2): compare relatively
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       rtol=2e-6, atol=ATOL)

    def test_sample_ggx_vndf(self):
        rng = np.random.default_rng(5)
        ve = rng.normal(size=(256, 3)).astype(np.float32)
        ve[:, 2] = np.abs(ve[:, 2])
        ve /= np.linalg.norm(ve, axis=-1, keepdims=True)
        ax = rng.uniform(0.05, 1, 256).astype(np.float32)
        u1 = rng.random(256).astype(np.float32)
        u2 = rng.random(256).astype(np.float32)
        want = np.asarray(jbrdf.sample_ggx_vndf(ve, ax, ax, u1, u2))
        t = torch.from_numpy
        got = _np(tbrdf.sample_ggx_vndf(t(ve), t(ax), t(ax), t(u1), t(u2)))
        # cos/sin of 2*pi*u2 differ by an ulp between libraries; the
        # normalization amplifies that at grazing samples: 1e-5
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_halton_table(self):
        np.testing.assert_array_equal(tbrdf.halton23_table(128),
                                      jbrdf.halton23_table(128))


class TestFormats:
    @pytest.mark.parametrize("bits", [8, 16, 24])
    def test_quantize_unorm(self, bits):
        x = np.random.default_rng(bits).uniform(-0.1, 1.1, 4096).astype(
            np.float32)
        np.testing.assert_array_equal(
            _np(tformats.quantize_unorm(torch.from_numpy(x), bits)),
            np.asarray(jformats.quantize_unorm(jnp.asarray(x), bits)))

    def test_srgb_and_f16(self):
        x = np.random.default_rng(6).uniform(-0.1, 1.1, 4096).astype(
            np.float32)
        t = torch.from_numpy(x)
        np.testing.assert_allclose(_np(tformats.srgb_to_linear(t)),
                                   np.asarray(jformats.srgb_to_linear(x)),
                                   atol=ATOL)
        np.testing.assert_allclose(_np(tformats.linear_to_srgb(t)),
                                   np.asarray(jformats.linear_to_srgb(x)),
                                   atol=ATOL)
        v = np.random.default_rng(7).normal(size=4096).astype(np.float32)
        np.testing.assert_array_equal(
            _np(tformats.quantize_f16(torch.from_numpy(v))),
            np.asarray(jformats.quantize_f16(jnp.asarray(v))))
