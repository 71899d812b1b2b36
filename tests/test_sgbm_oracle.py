"""NumPy SGBM oracle sanity + parity of the JAX implementation vs oracle
(SURVEY.md §4: "SGBM cost/aggregation kernels vs a small pure-NumPy SGBM
oracle on tiny images")."""

import numpy as np
import pytest

from stereo_depth_ruler_tpu.ops import sgbm as jsgbm
from stereo_depth_ruler_tpu.ops import sgbm_ref as nref
from stereo_depth_ruler_tpu.ops.sgbm_ref import SGBMParams

PARAMS = SGBMParams(num_disparities=16, block_size=3, p1=72, p2=288,
                    speckle_window_size=20, speckle_range=1)


@pytest.fixture(scope="module")
def tiny(tiny_pair):
    left, right, gt = tiny_pair
    return left, right, gt


def test_oracle_recovers_gt(tiny):
    left, right, gt = tiny
    disp = nref.sgbm_numpy(left, right, PARAMS)
    valid = disp >= 0
    # exclude the unreliable left band (reference does too,
    # stereo_displayer.cpp:107)
    sel = valid[:, PARAMS.num_disparities:]
    err = np.abs(disp[:, PARAMS.num_disparities:][sel]
                 - gt[:, PARAMS.num_disparities:][sel])
    assert sel.mean() > 0.5
    assert np.median(err) < 1.0


def test_sobel_parity(tiny):
    left, _, _ = tiny
    a = nref.sobel_clip_np(left, 63)
    b = np.asarray(jsgbm.sobel_clip(left, 63))
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_cost_volume_parity(tiny):
    left, right, _ = tiny
    lt = nref.sobel_clip_np(left, 63)
    rt = nref.sobel_clip_np(right, 63)
    a = nref.bt_cost_volume_np(lt, rt, 16)
    b = np.asarray(jsgbm.bt_cost_volume(
        np.float32(lt), np.float32(rt), 16))
    np.testing.assert_allclose(a, b, atol=1e-3)


def test_box_filter_parity(tiny):
    left, right, _ = tiny
    lt = nref.sobel_clip_np(left, 63)
    rt = nref.sobel_clip_np(right, 63)
    C = nref.bt_cost_volume_np(lt, rt, 16)
    a = nref.box_filter_volume_np(C, 5)
    b = np.asarray(jsgbm.box_filter_volume(np.float32(C), 5))
    np.testing.assert_allclose(a, b, atol=1e-2)


@pytest.mark.parametrize("num_paths", [2, 4, 8])
def test_aggregation_parity(tiny, num_paths):
    left, right, _ = tiny
    lt = nref.sobel_clip_np(left, 63)
    rt = nref.sobel_clip_np(right, 63)
    C = nref.box_filter_volume_np(
        nref.bt_cost_volume_np(lt, rt, 16), 3)
    dirs = {8: nref.PATH_DIRS_8, 4: nref.PATH_DIRS_4,
            2: nref.PATH_DIRS_2}[num_paths]
    a = nref.aggregate_np(C, 72, 288, dirs)
    b = np.asarray(jsgbm.aggregate_paths(np.float32(C), 72, 288, num_paths))
    np.testing.assert_allclose(a, b, atol=0.5, rtol=1e-6)


def test_full_pipeline_parity(tiny):
    """End-to-end oracle vs JAX: same winners, same validity, same
    subpixel values (up to f32/f64 rounding at the 1/16 quantization)."""
    left, right, _ = tiny
    a = nref.sgbm_numpy(left, right, PARAMS)
    b = np.asarray(jsgbm.sgbm(np.float32(left), np.float32(right), PARAMS))
    same_validity = (a >= 0) == (b >= 0)
    assert same_validity.mean() > 0.99
    both = (a >= 0) & (b >= 0)
    np.testing.assert_allclose(a[both], b[both], atol=1 / 16 + 1e-4)


def test_speckle_filter_parity():
    """jnp CCL speckle filter == flood-fill oracle on random label maps."""
    rng = np.random.default_rng(7)
    for trial in range(4):
        disp = rng.integers(0, 6, size=(24, 32)).astype(np.float32)
        valid = rng.random((24, 32)) > 0.3
        a = nref.speckle_filter_np(disp, valid, max_size=8, max_diff=1.0)
        b = np.asarray(jsgbm.speckle_filter(disp, valid, 8, 1.0))
        np.testing.assert_array_equal(a, b, err_msg=f"trial {trial}")


def test_lr_check_parity(tiny):
    left, right, _ = tiny
    lt = nref.sobel_clip_np(left, 63)
    rt = nref.sobel_clip_np(right, 63)
    C = nref.box_filter_volume_np(
        nref.bt_cost_volume_np(lt, rt, 16), 3)
    S = nref.aggregate_np(C, 72, 288, nref.PATH_DIRS_4)
    disp, valid = nref.wta_np(S, PARAMS)
    a = nref.lr_check_np(S, disp, valid, PARAMS)
    b = np.asarray(jsgbm.lr_check(
        np.float32(S), np.float32(disp), valid, PARAMS))
    assert (a == b).mean() > 0.995


def _rand_pair(H, W, shift, seed):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (H, W)).astype(np.float32)
    right = (np.roll(left, -shift, axis=1)
             + rng.normal(0, 2, (H, W))).astype(np.float32)
    return left, right


def _assert_matches_oracle(left, right, params, apply_lr=True):
    """jnp matcher vs the NumPy oracle: identical validity on >= 99% of
    pixels and subpixel values within the 1/16 quantum."""
    a = nref.sgbm_numpy(left, right, params, apply_lr=apply_lr)
    b = np.asarray(jsgbm.sgbm(left, right, params, apply_lr=apply_lr))
    assert ((a >= 0) == (b >= 0)).mean() > 0.99
    both = (a >= 0) & (b >= 0)
    np.testing.assert_allclose(a[both], b[both], atol=1 / 16 + 1e-4)


@pytest.mark.parametrize("min_disp", [0, 3])
def test_min_disparity_with_lr_vs_oracle(tiny, min_disp):
    """min_disparity offsets the volume, WTA and the LR winner scatter."""
    left, right, _ = tiny
    p = SGBMParams(num_disparities=16, block_size=5, p1=72, p2=288,
                   speckle_window_size=0, min_disparity=min_disp)
    _assert_matches_oracle(np.float32(left), np.float32(right), p)


@pytest.mark.parametrize("apply_lr", [True, False])
def test_block_size_one_vs_oracle(tiny, apply_lr):
    """block_size=1: the box filter is the identity."""
    left, right, _ = tiny
    p = SGBMParams(num_disparities=16, block_size=1, p1=8, p2=32,
                   speckle_window_size=0)
    _assert_matches_oracle(np.float32(left), np.float32(right), p,
                           apply_lr=apply_lr)


def test_sweep_width_and_disparities_vs_oracle():
    """The 2560x1440x256 sweep's full W and D at reduced H."""
    left, right = _rand_pair(6, 2560, 9, seed=0)
    p = SGBMParams(num_disparities=256, block_size=5,
                   speckle_window_size=0)
    _assert_matches_oracle(left, right, p)


@pytest.mark.parametrize("shape", [(64, 256, 32), (48, 160, 16)])
def test_disparity_pair_vs_oracle(shape):
    """compute_disparity_pair (left matcher + mirrored right matcher) vs
    the oracle run on the same two constructions."""
    H, W, D = shape
    left, right = _rand_pair(H, W, 5, seed=H + W)
    p = SGBMParams(num_disparities=D, block_size=5,
                   speckle_window_size=50, speckle_range=2)
    dl, dr = jsgbm.compute_disparity_pair(left, right, p)
    al = nref.sgbm_numpy(left, right, p)
    ar = nref.sgbm_numpy(right[:, ::-1], left[:, ::-1], p)[:, ::-1]
    for a, b in ((al, np.asarray(dl)), (ar, np.asarray(dr))):
        assert ((a >= 0) == (b >= 0)).mean() > 0.99
        both = (a >= 0) & (b >= 0)
        np.testing.assert_allclose(a[both], b[both], atol=1 / 16 + 1e-4)


@pytest.mark.parametrize("shape,levels", [((8, 128), 37), ((23, 41), 5),
                                          ((60, 100), 9), ((32, 129), 2)])
@pytest.mark.parametrize("max_size", [1, 4, 50])
def test_speckle_filter_vs_oracle(shape, levels, max_size):
    """jnp CCL speckle filter == flood-fill oracle across shapes (odd and
    lane-unaligned widths) and component-size thresholds."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + max_size)
    disp = rng.integers(0, levels, shape).astype(np.float32)
    valid = rng.random(shape) > 0.25
    want = nref.speckle_filter_np(disp, valid, max_size, 1.0)
    got = np.asarray(jsgbm.speckle_filter(disp, valid, max_size, 1.0))
    np.testing.assert_array_equal(got, want)


def test_speckle_filter_threshold_boundary():
    """Components of exactly max_size pixels go; max_size + 1 stay
    (cv::filterSpeckles: strictly greater survives), snakes included."""
    disp = np.full((16, 130), -1.0, np.float32)
    disp[2, 10:15] = 3.0          # size 5 == max_size -> removed
    disp[5, 20:26] = 3.0          # size 6 -> kept
    disp[8, 40:45] = 2.0          # snaky component, 5 + 4 + 5 = 14 -> kept
    disp[9:13, 44] = 2.0
    disp[12, 40:44] = 2.0
    valid = disp >= 0
    got = np.asarray(jsgbm.speckle_filter(disp, valid, 5, 1.0))
    np.testing.assert_array_equal(
        got, nref.speckle_filter_np(disp, valid, 5, 1.0))
    assert not got[2, 12] and got[5, 22] and got[12, 41]


def test_speckle_filter_vmap_vs_oracle():
    """Batched speckle filter (the pipeline vmaps it) == per-frame oracle."""
    import jax
    rng = np.random.default_rng(9)
    disp = rng.integers(0, 4, (3, 24, 40)).astype(np.float32)
    valid = rng.random(disp.shape) > 0.3
    got = np.asarray(jax.vmap(
        lambda d, v: jsgbm.speckle_filter(d, v, 6, 1.0))(disp, valid))
    want = np.stack([nref.speckle_filter_np(d, v, 6, 1.0)
                     for d, v in zip(disp, valid)])
    np.testing.assert_array_equal(got, want)
