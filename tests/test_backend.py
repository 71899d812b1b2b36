"""The platform selector (ops/backend.py): one choice of SGM aggregator,
routed to by every matcher entry point, and an error — never a silent
fallback — on any platform other than cpu or gpu. Also the compile-cache
rule (utils/cache.py)."""

import jax
import numpy as np
import pytest

from stereo_depth_ruler_tpu.calib.config import StereoRig
from stereo_depth_ruler_tpu.ops import backend
from stereo_depth_ruler_tpu.ops.sgbm import SGBMParams, aggregate_paths
from stereo_depth_ruler_tpu.ops.sgm_gpu import aggregate_paths_gpu

UNKNOWN = ["rocm", "METAL", "neuron"]
PARAMS = SGBMParams(num_disparities=16, block_size=3, p1=72, p2=288,
                    speckle_window_size=0)


@pytest.fixture
def on_platform(monkeypatch):
    """Make jax.default_backend() report the given platform."""
    def set_(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
    return set_


def test_cpu_picks_jnp_scan(on_platform):
    on_platform("cpu")
    assert backend.select_aggregator() is aggregate_paths


def test_gpu_picks_triton_kernel(on_platform):
    on_platform("gpu")
    assert backend.select_aggregator() is aggregate_paths_gpu


def test_explicit_platform_overrides_default(on_platform):
    on_platform("gpu")
    assert backend.select_aggregator("cpu") is aggregate_paths
    assert backend.platform("cpu") == "cpu"


@pytest.mark.parametrize("name", UNKNOWN)
def test_unknown_platform_is_an_error(on_platform, name):
    on_platform(name)
    with pytest.raises(ValueError, match="no SGM aggregator"):
        backend.select_aggregator()


def _pipeline():
    from stereo_depth_ruler_tpu.pipeline import PipelineConfig, StereoPipeline
    StereoPipeline(StereoRig.synthetic(width=32, height=16),
                   PipelineConfig(sgbm=PARAMS), rectify=False)


def _cloud():
    from stereo_depth_ruler_tpu.cloud import PointCloudGenerator
    PointCloudGenerator(StereoRig.synthetic(width=32, height=16))


def _sharded():
    from stereo_depth_ruler_tpu.parallel.mesh import make_mesh
    from stereo_depth_ruler_tpu.parallel.sharded import sgbm_sharded
    img = np.zeros((16, 32), np.float32)
    sgbm_sharded(img, img, PARAMS, make_mesh(devices=jax.devices()[:1]))


def _sharded_pipeline():
    from stereo_depth_ruler_tpu.parallel.mesh import make_mesh
    from stereo_depth_ruler_tpu.parallel.sharded import pipeline_step_sharded
    imgs = np.zeros((1, 16, 32), np.float32)
    pipeline_step_sharded(imgs, imgs, np.eye(4), PARAMS,
                          make_mesh(devices=jax.devices()[:1]))


@pytest.mark.parametrize("entry", [_pipeline, _cloud, _sharded,
                                   _sharded_pipeline],
                         ids=["pipeline", "cloud", "sharded",
                              "sharded_pipeline"])
def test_entry_points_refuse_unknown_platform(on_platform, entry):
    on_platform("rocm")
    with pytest.raises(ValueError, match="no SGM aggregator"):
        entry()


def test_pipeline_uses_selected_aggregator(on_platform, monkeypatch):
    """StereoPipeline asks the selector, at construction."""
    from stereo_depth_ruler_tpu.pipeline import PipelineConfig, StereoPipeline
    calls = []

    def fake(name=None):
        calls.append(name)
        return aggregate_paths
    monkeypatch.setattr("stereo_depth_ruler_tpu.pipeline.select_aggregator",
                        fake)
    pipe = StereoPipeline(StereoRig.synthetic(width=32, height=16),
                          PipelineConfig(sgbm=PARAMS), rectify=False)
    assert calls == [None]
    assert pipe._matcher.keywords["aggregator"] is aggregate_paths


def test_compile_cache_env_set(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: used as is, nothing else set."""
    from stereo_depth_ruler_tpu.utils import cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    updates = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: updates.append(a))
    assert cache.enable_compile_cache() == str(tmp_path / "c")
    assert updates == []


def test_compile_cache_env_unset(monkeypatch):
    """Unset: the fixed <checkout>/.jax_cache."""
    from pathlib import Path

    from stereo_depth_ruler_tpu.utils import cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    checkout = Path(__file__).resolve().parents[1]
    got = cache.enable_compile_cache()
    assert got == str(checkout / ".jax_cache")
    assert updates["jax_compilation_cache_dir"] == got
    assert (checkout / ".jax_cache").is_dir()
