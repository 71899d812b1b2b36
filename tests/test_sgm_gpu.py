"""The GPU SGM traversal kernel (ops/sgm_gpu.py) against jnp
`aggregate_paths`, bitwise, through the Triton route in interpret mode;
plus its d±1 shift and its lowering to Triton for the CUDA platform."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_depth_ruler_tpu.ops.sgbm import aggregate_paths
from stereo_depth_ruler_tpu.ops.sgm_gpu import _shift_d, aggregate_paths_gpu

P1, P2 = 72.0, 288.0


def _cost(shape, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(0, 400, shape).astype(np.float32))


# odd widths, W < H and W > H, D a power of two and not
@pytest.mark.parametrize("shape", [(24, 41, 16), (32, 48, 16),
                                   (16, 160, 32), (9, 13, 5)])
@pytest.mark.parametrize("num_paths", [2, 4, 8])
def test_kernel_matches_jnp_bitwise(shape, num_paths):
    C = _cost(shape, seed=sum(shape) + num_paths)
    want = np.asarray(aggregate_paths(C, P1, P2, num_paths))
    got = np.asarray(aggregate_paths_gpu(C, P1, P2, num_paths,
                                         interpret=True))
    np.testing.assert_array_equal(got, want)


def test_kernel_vmapped_batch():
    """The batch of the pipeline's vmap becomes a grid axis."""
    C = _cost((3, 12, 19, 24), seed=5)
    want = np.asarray(jax.vmap(
        lambda c: aggregate_paths(c, P1, P2, 8))(C))
    got = np.asarray(jax.vmap(
        lambda c: aggregate_paths_gpu(c, P1, P2, 8, interpret=True))(C))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 8, 128])
def test_shift_d(n):
    x = jnp.arange(3 * n, dtype=jnp.float32).reshape(3, n)
    big = np.full((3, 1), 1e9, np.float32)
    xn = np.asarray(x)
    np.testing.assert_array_equal(
        np.asarray(_shift_d(x, True)),
        np.concatenate([big, xn[:, :-1]], axis=1))
    np.testing.assert_array_equal(
        np.asarray(_shift_d(x, False)),
        np.concatenate([xn[:, 1:], big], axis=1))


def test_kernel_lowers_to_triton_for_cuda():
    """The kernel lowers through Pallas' Triton route for the CUDA
    platform (no GPU needed to lower; compiling it needs the card)."""
    f = jax.jit(jax.vmap(lambda c: aggregate_paths_gpu(c, P1, P2, 8)))
    text = f.trace(jax.ShapeDtypeStruct((2, 20, 37, 24), jnp.float32)
                   ).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 8
