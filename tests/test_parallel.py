"""Sharded SGBM on the 8-virtual-device CPU mesh (SURVEY.md §4
'Distributed without a cluster'): exact-mode bitwise identity, halo-mode
accuracy, disp-axis path parallelism, frame data parallelism."""

import jax
import numpy as np
import pytest

from stereo_depth_ruler_tpu.ops.sgbm import SGBMParams, sgbm
from stereo_depth_ruler_tpu.parallel.mesh import make_mesh
from stereo_depth_ruler_tpu.parallel.sharded import (pipeline_step_sharded,
                                                     sgbm_sharded)

PARAMS = SGBMParams(num_disparities=16, block_size=3, p1=72, p2=288,
                    speckle_window_size=20, speckle_range=1)


@pytest.fixture(scope="module")
def pair(tiny_pair):
    left, right, _ = tiny_pair
    return np.float32(left), np.float32(right)


@pytest.fixture(scope="module")
def single(pair):
    left, right = pair
    return np.asarray(sgbm(left, right, PARAMS))


def _need(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def test_exact_wavefront_bitwise(pair, single):
    """tile=4 exact mode must equal single-device bitwise."""
    _need(4)
    left, right = pair
    mesh = make_mesh(tile=4)
    out = np.asarray(sgbm_sharded(left, right, PARAMS, mesh, exact=True))
    np.testing.assert_array_equal(out, single)


def test_halo_mode_close(pair, single):
    """tile=4 halo mode: large halo ⇒ agreement almost everywhere."""
    _need(4)
    left, right = pair
    mesh = make_mesh(tile=4)
    out = np.asarray(sgbm_sharded(left, right, PARAMS, mesh, halo=8))
    both = (out >= 0) & (single >= 0)
    agree = np.abs(out[both] - single[both]) <= 1.0
    assert agree.mean() > 0.97
    assert (out >= 0).mean() == pytest.approx((single >= 0).mean(), abs=0.05)


def test_dshard_exact_bitwise(pair, single):
    """disp=4 D-axis sharding (each member holds a 4-plane slice of the
    16-disparity volume): the per-step pmin/ppermute couplings and the
    all-reduce WTA/uniqueness/subpixel/LR must reproduce the unsharded
    matcher bitwise (SURVEY §2.10 'Disparity-range parallel')."""
    _need(4)
    left, right = pair
    mesh = make_mesh(tile=1, disp=4)
    out = np.asarray(sgbm_sharded(left, right, PARAMS, mesh, exact=True))
    np.testing.assert_array_equal(out, single)


def test_dshard_tile_exact_bitwise(pair, single):
    """tile=2 x disp=2 exact wavefront + D-sharding composed: bitwise."""
    _need(4)
    left, right = pair
    mesh = make_mesh(tile=2, disp=2)
    out = np.asarray(sgbm_sharded(left, right, PARAMS, mesh, exact=True))
    np.testing.assert_array_equal(out, single)


def test_dshard_local_slab_is_slice():
    """The local cost slab really is a D-slice (memory scales by 1/n)."""
    from stereo_depth_ruler_tpu.parallel.sharded import _local_cost_slab
    rng = np.random.default_rng(0)
    left = rng.uniform(0, 255, (16, 32)).astype(np.float32)
    right = np.roll(left, -3, axis=1).astype(np.float32)
    full = np.asarray(_local_cost_slab(left, right, PARAMS, 0, 16))
    assert full.shape == (16, 32, 16)
    for k in range(4):
        part = np.asarray(_local_cost_slab(left, right, PARAMS, 0, 16,
                                           disp_idx=k, n_disp=4))
        assert part.shape == (16, 32, 4)
        np.testing.assert_array_equal(part, full[:, :, 4 * k:4 * k + 4])


def test_dshard_halo_close(pair, single):
    """tile=2 x disp=2 halo mode with full-coverage halo: near-exact."""
    _need(4)
    left, right = pair
    mesh = make_mesh(tile=2, disp=2)
    out = np.asarray(sgbm_sharded(left, right, PARAMS, mesh, exact=False,
                                  halo=16))
    # halo=16 >= h_local: warmup covers the whole neighbor slab => exact
    # for 32-row image split in 2 (16-row tiles, full-coverage halo)
    both = (out >= 0) & (single >= 0)
    agree = np.abs(out[both] - single[both]) <= 1.0 / 16.0
    assert agree.mean() > 0.99


def test_frame_sharded_pipeline_step(pair):
    _need(8)
    left, right = pair
    H, W = left.shape
    lefts = np.stack([left, np.roll(left, 2, axis=1)])
    rights = np.stack([right, np.roll(right, 2, axis=1)])
    mesh = make_mesh(frame=2, tile=2, disp=2)
    Q = np.array([[1.0, 0, 0, -W / 2], [0, 1.0, 0, -H / 2],
                  [0, 0, 0, 50.0], [0, 0, 1.0 / 30.0, 0]])
    out = pipeline_step_sharded(lefts, rights, Q, PARAMS, mesh, halo=8)
    d = np.asarray(out["disparity"])
    xyz = np.asarray(out["xyz"])
    assert d.shape == (2, H, W)
    assert xyz.shape == (2, H, W, 3)
    # frame 0 must match the single-pair sharded run (same math)
    mesh2 = make_mesh(tile=2, disp=2)
    ref0 = np.asarray(sgbm_sharded(left, right, PARAMS, mesh2, halo=8,
                                   apply_speckle=False))
    np.testing.assert_allclose(d[0], ref0, atol=1e-5)
    # depth sanity: Z = f*B/d on valid pixels
    valid = d[0] > 0
    z = xyz[0, ..., 2][valid]
    expect = 50.0 * 30.0 / d[0][valid]
    np.testing.assert_allclose(z, expect, rtol=1e-4)


def test_mesh_shapes():
    _need(8)
    mesh = make_mesh(frame=2, tile=2, disp=2)
    assert mesh.shape == {"frame": 2, "tile": 2, "disp": 2}
    with pytest.raises(ValueError):
        make_mesh(frame=16, tile=4)
