"""The port's registry (core/registry.py) and pass graph (core/graph.py)
against vkr_tpu's: the manifest names, what each name resolves to, hot
reload, the `setattr` swaps that chip_smoke.py and profile_frame.py make,
and the DAG dump."""

import importlib
import pkgutil
import sys
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The suite runs in several worker processes on a few cores: one torch
# thread each keeps their intra-op pools from spinning against each other.
torch.set_num_threads(1)


def _import_all(package: str):
    """Import the package's frame and every pass and raster module, as
    vkr_tpu's tests/test_manifest.py does."""
    importlib.import_module(f"{package}.frame")
    for sub in ("passes", "raster"):
        pkg = importlib.import_module(f"{package}.{sub}")
        for info in pkgutil.iter_modules(pkg.__path__):
            importlib.import_module(f"{pkg.__name__}.{info.name}")


def _package_names(registry, package: str):
    """The names registered by the package's own modules (a test elsewhere
    in the same process may register one of its own)."""
    return sorted(n for n in registry.names()
                  if registry._REGISTRY[n][0].startswith(package + "."))


@pytest.fixture(scope="module")
def registries():
    from vkr_tpu.core import registry as jreg
    from vkr_tpu_torch.core import registry as treg

    _import_all("vkr_tpu")
    _import_all("vkr_tpu_torch")
    return jreg, treg


def test_names_equal_vkr_tpu(registries):
    jreg, treg = registries
    want = _package_names(jreg, "vkr_tpu")
    got = _package_names(treg, "vkr_tpu_torch")
    assert len(want) == 41
    assert got == want


def test_each_name_resolves_to_the_counterpart(registries):
    """vkr_tpu.passes.m.f -> vkr_tpu_torch.passes.m.f, aliases included
    (gtao_rt_main, downsample_depth, ...)."""
    jreg, treg = registries
    for name in _package_names(jreg, "vkr_tpu"):
        jmod, jqual = jreg._REGISTRY[name]
        tmod, tqual = treg._REGISTRY[name]
        assert tmod == "vkr_tpu_torch" + jmod[len("vkr_tpu"):], name
        assert tqual == jqual, name
        fn = treg.get(name)
        assert callable(fn) and fn is getattr(sys.modules[tmod], tqual)
        assert fn.__name__ == jreg.get(name).__name__, name
    assert treg.get("gtao_rt_main") is treg.get("gtao_rt")
    assert treg.get("downsample_depth") is treg.get("depth_mips")


def test_swap_by_setattr_reaches_a_registry_call(registries):
    """A function swapped on its module (a plain version for a kernel, a
    timer around a pass) is what the next registry.get returns, and so
    what the frame calls."""
    _, treg = registries
    from vkr_tpu_torch.passes import gtao

    calls = []
    original = gtao.gtao_filter

    def wrapped(*args, **kw):
        calls.append(1)
        return original(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gtao, "gtao_filter", wrapped)
        depth = torch.full((8, 8), 0.5)
        out = treg.get("gtao_filter")(depth, torch.ones(8, 8), 0.05, 80.0)
    assert calls == [1]
    torch.testing.assert_close(out, torch.ones(8, 8))
    assert treg.get("gtao_filter") is original


def test_hot_reload_takes_effect_without_restart(registries, tmp_path):
    """The reference's key-R hot reload (main.cpp:319-321): an edited pass
    module and registry.reload() change the next call of a function that
    resolves the pass through the registry, as test_aux.py holds
    vkr_tpu's; reload also empties the loaded CUDA libraries and the
    tracked caches."""
    _, treg = registries
    from vkr_tpu_torch import frame, kernels

    mod_path = tmp_path / "hot_torch_pass_mod.py"
    source = ("from vkr_tpu_torch.core.registry import register\n"
              "@register('hot_torch_test_pass')\n"
              "def run(x):\n"
              "    return x * {}\n")
    mod_path.write_text(source.format(2))
    sys.path.insert(0, str(tmp_path))
    try:
        import hot_torch_pass_mod  # noqa: F401

        def render(x):
            return treg.get("hot_torch_test_pass")(x)

        x = torch.ones(8)
        assert float(render(x)[0]) == 2.0
        frame._rt_direction_table(4, "cpu")
        assert frame._rt_direction_table.cache_info().currsize >= 1
        sentinel = object()
        kernels._loaded["sentinel"] = sentinel
        # another length too: a .pyc of the same second and size is reused
        mod_path.write_text(source.format("(2 + 1)"))
        importlib.invalidate_caches()
        reloaded = treg.reload("hot_torch_pass_mod")
        assert reloaded == ["hot_torch_pass_mod"]
        assert float(render(x)[0]) == 3.0
        assert "sentinel" not in kernels._loaded
        assert frame._rt_direction_table.cache_info().currsize == 0
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("hot_torch_pass_mod", None)
        treg._REGISTRY.pop("hot_torch_test_pass", None)
        kernels._loaded.pop("sentinel", None)


class _Params(NamedTuple):
    mat: object
    fovy: float
    flags: object


def test_pass_graph_dump_equals_vkr_tpu():
    """The same two add_task calls on both sides, with a NamedTuple
    argument, a None, Python scalars, a bool array, a dict and a keyword:
    the same dump, line for line."""
    from vkr_tpu.core.graph import PassGraph as JGraph
    from vkr_tpu.core.graph import add_task as j_add
    from vkr_tpu_torch.core.graph import PassGraph, add_task

    def run(add, graph_cls, arr):
        graph = graph_cls()
        params = _Params(arr(np.eye(4, dtype=np.float32)), 1.2, None)
        with graph.recording():
            x = add("A", lambda p, n, k, scale=1.0: (p.mat * scale, n),
                    params, None, 3, scale=2.0)
            add("B", lambda d: {"y": d["x"] + 1, "mask": d["x"] > 0},
                {"x": x[0], "m": arr(np.zeros((2, 3), bool))})
        return graph.dump()

    want = run(j_add, JGraph, jnp.asarray)
    got = run(add_task, PassGraph, torch.from_numpy)
    assert got == want
    assert "bool[4, 4]" in got and "float[]" in got and "int[]" in got


def test_add_task_records_only_while_recording():
    from vkr_tpu_torch.core.graph import PassGraph, add_task

    graph = PassGraph()
    assert add_task("A", lambda: torch.ones(2)).shape == (2,)
    assert graph.records == []
    with graph.recording():
        add_task("B", lambda t: t + 1, torch.zeros(3, dtype=torch.int32))
    add_task("C", lambda: None)
    assert [r.name for r in graph.records] == ["B"]
    assert graph.records[0].inputs == ["int32[3]"]
    assert PassGraph._active is None
