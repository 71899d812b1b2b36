"""The GPU path against the jnp reference at the headline size,
1280x720x128. Needs the card (marker ``gpu``; the `gpu_device` fixture
skips without one):

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

H, W, D = 720, 1280, 128


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (H, W)).astype(np.float32)
    right = np.roll(left, -11, axis=1) + rng.normal(0, 2, (H, W))
    return left, right.astype(np.float32)


@pytest.mark.parametrize("num_paths", [4, 8])
def test_traversal_kernel_bitwise_on_card(gpu_device, num_paths):
    import jax
    import jax.numpy as jnp
    from stereo_depth_ruler_tpu.ops.sgbm import (SGBMParams, aggregate_paths,
                                                 box_filter_volume,
                                                 bt_cost_volume, sobel_clip)
    from stereo_depth_ruler_tpu.ops.sgm_gpu import aggregate_paths_gpu
    p = SGBMParams(num_disparities=D)
    left, right = (jax.device_put(a, gpu_device) for a in _pair())
    C = jnp.stack([box_filter_volume(bt_cost_volume(
        sobel_clip(left, 63), sobel_clip(right, 63), D), 5)] * 2)
    same = jax.jit(lambda c: jnp.array_equal(
        jax.vmap(lambda x: aggregate_paths_gpu(x, p.P1, p.P2, num_paths))(c),
        jax.vmap(lambda x: aggregate_paths(x, p.P1, p.P2, num_paths))(c)))(C)
    assert bool(same)


def test_matcher_on_card_matches_cpu(gpu_device):
    """Full matcher (cost, GPU aggregation, WTA, LR, speckle) on the card
    vs the jnp matcher on the host CPU: the integer DP is exact, so only
    the float32 subpixel division may differ."""
    import jax
    from stereo_depth_ruler_tpu.ops.backend import select_aggregator
    from stereo_depth_ruler_tpu.ops.sgbm import SGBMParams, sgbm
    p = SGBMParams(num_disparities=D)
    left, right = _pair(1)
    got = np.asarray(jax.jit(lambda a, b: sgbm(
        a, b, p, aggregator=select_aggregator("gpu")))(
            jax.device_put(left, gpu_device),
            jax.device_put(right, gpu_device)))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        want = np.asarray(jax.jit(lambda a, b: sgbm(
            a, b, p, aggregator=select_aggregator("cpu")))(left, right))
    assert (got == want).mean() >= 0.9999
    assert np.abs(got - want).max() <= 1 / 16
