"""Rectification remap parity vs cv2.initUndistortRectifyMap / cv2.remap
(SURVEY.md §2.3 / §4 unit tests)."""

import dataclasses

import numpy as np
import pytest

from stereo_depth_ruler_tpu.calib.config import StereoRig
from stereo_depth_ruler_tpu.ops.remap import (
    RemapGrid, build_remap_grids, compute_rectify_map, remap_bilinear)

cv2 = pytest.importorskip("cv2")


def _verged_rig():
    """A distorted synthetic rig with non-identity rectifying rotations,
    as cv2.stereoRectify returns for a slightly verged pair."""
    base = StereoRig.synthetic(width=1280, height=720, distortion=True)
    R1 = cv2.Rodrigues(np.array([0.010, -0.020, 0.005]))[0]
    R2 = cv2.Rodrigues(np.array([0.012, -0.018, 0.004]))[0]
    return dataclasses.replace(base, R1=R1, R2=R2)


@pytest.fixture(scope="module", params=["synthetic", "reference"])
def ref_rig(request):
    """The verged synthetic rig, and the real calibration where the
    reference checkout is present (only that variant may skip)."""
    if request.param == "synthetic":
        return _verged_rig()
    from test_config import REF_YAML
    if not REF_YAML.exists():
        pytest.skip("reference calibration not available")
    return StereoRig.from_yaml(REF_YAML)


def test_map_parity_reference_rig(ref_rig):
    """Our remap tables match cv2.initUndistortRectifyMap (both eyes)."""
    assert not np.allclose(ref_rig.R1, np.eye(3)) or \
        ref_rig.dist_coeffs_left.any()
    for K, dist, R, P in [
        (ref_rig.camera_matrix_left, ref_rig.dist_coeffs_left,
         ref_rig.R1, ref_rig.P1),
        (ref_rig.camera_matrix_right, ref_rig.dist_coeffs_right,
         ref_rig.R2, ref_rig.P2),
    ]:
        mx, my = compute_rectify_map(K, dist, R, P, ref_rig.image_size)
        cx, cy = cv2.initUndistortRectifyMap(
            K, dist, R, P, ref_rig.image_size, cv2.CV_32FC1)
        np.testing.assert_allclose(mx, cx, atol=2e-3)
        np.testing.assert_allclose(my, cy, atol=2e-3)


def test_remap_parity_vs_cv2(ref_rig):
    """Device bilinear remap matches cv2.remap INTER_LINEAR (the op
    StereoRectifier::rectify performs, stereo_rectifier.cpp:39-40)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(720, 1280), dtype=np.uint8)
    gl, _ = build_remap_grids(ref_rig)
    ours = np.asarray(remap_bilinear(img, gl))

    mx, my = compute_rectify_map(
        ref_rig.camera_matrix_left, ref_rig.dist_coeffs_left,
        ref_rig.R1, ref_rig.P1, ref_rig.image_size)
    theirs = cv2.remap(img.astype(np.float32), mx, my, cv2.INTER_LINEAR)
    # compare where the bilinear support is fully in-bounds (border handling
    # at the image edge differs by design: we zero, cv2 clamps partially)
    valid = np.asarray(gl.valid)
    assert valid.mean() > 0.5
    diff = np.abs(ours - theirs)[valid]
    assert np.percentile(diff, 99.9) < 0.75   # fixed-point-free, sub-LSB
    assert diff.mean() < 0.05


def test_identity_rig_remap_is_identity():
    rig = StereoRig.synthetic(width=64, height=48, focal=80.0)
    gl, gr = build_remap_grids(rig)
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, size=(48, 64)).astype(np.float32)
    out = np.asarray(remap_bilinear(img, gl))
    # identity rig: interior must be exactly preserved
    np.testing.assert_allclose(out[1:-1, 1:-1], img[1:-1, 1:-1], atol=1e-3)


def test_batched_remap():
    rig = StereoRig.synthetic(width=64, height=48, focal=80.0,
                              distortion=True)
    gl, _ = build_remap_grids(rig)
    rng = np.random.default_rng(2)
    imgs = rng.uniform(0, 255, size=(3, 48, 64)).astype(np.float32)
    out = np.asarray(remap_bilinear(imgs, gl))
    assert out.shape == (3, 48, 64)
    one = np.asarray(remap_bilinear(imgs[1], gl))
    np.testing.assert_array_equal(out[1], one)
