"""Test configuration: an 8-virtual-device CPU JAX platform by default.

Mirrors SURVEY.md §4 "Distributed without a cluster": sharding/collective
tests run on `--xla_force_host_platform_device_count=8` CPU meshes; the
numerical invariant is identity with the single-device run.

``JAX_PLATFORMS`` defaults to ``cpu``. The GPU tests (marker ``gpu``, see
`gpu_device` below) run on the card with ``JAX_PLATFORMS=cuda,cpu``: the
card for the code under test, the host CPU for the reference.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from stereo_depth_ruler_tpu.calib.config import StereoRig  # noqa: E402
from stereo_depth_ruler_tpu.io.synthetic import (  # noqa: E402
    make_scene, render_stereo_pair)


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU, or a skip: tests marked ``gpu`` need the card. The
    check runs here, inside the fixture, never at import or collection."""
    import jax
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on the "
                    "card: python -m pytest -m gpu tests/)")
    return gpus[0]


@pytest.fixture(scope="session")
def small_rig():
    """A small rectified rig for cheap CPU tests."""
    return StereoRig.synthetic(width=128, height=96, focal=120.0,
                               baseline_mm=60.0)


@pytest.fixture(scope="session")
def small_pair(small_rig):
    """(left, right, gt_disp) on the small rig; disparities ~5-25 px."""
    scene = make_scene(small_rig, n_boxes=3, z_range_mm=(300.0, 900.0),
                       background_z_mm=1500.0, seed=3)
    return render_stereo_pair(scene, seed=3)


@pytest.fixture(scope="session")
def tiny_pair():
    """Very small random-texture pair for exact oracle-vs-jax tests."""
    rng = np.random.default_rng(0)
    rig = StereoRig.synthetic(width=48, height=32, focal=50.0,
                              baseline_mm=30.0)
    scene = make_scene(rig, n_boxes=2, z_range_mm=(200.0, 400.0),
                       background_z_mm=700.0, seed=1)
    left, right, gt = render_stereo_pair(scene, seed=1)
    return left, right, gt
