"""SGM path aggregation as a GPU kernel (Pallas, Triton route).

The GPU decomposition of semi-global matching (Hernandez-Juarez et al.,
arXiv 1610.04121): every scan line of a direction is an independent
recurrence, so one program owns a block of lines — rows for the
horizontal paths, columns for the vertical ones, y−x = const or
y+x = const for the diagonals — and walks along them in an in-kernel
`fori_loop` with the (lines, D) carry in registers. The min over D is a
block reduction; the d±1 neighbours of the carry come from an
interleave-based shift (`_shift_d`) that uses only the reshapes, splits
and joins Triton can express. Each direction adds its L into the running
path sum S, so the kernel reads C and S and writes S, and nothing else.

Diagonal lines have different lengths: positions outside the image are
masked, and the carry is reset there to the fresh path-start state (the
zero vector), exactly as `ops.sgbm.aggregate_paths` enters a path from
the border. D is padded to a power of two with +BIG lanes, which never
win a min, and a spare row absorbs the loads and stores of masked
positions. Every value is an exact small integer in float32, so S is
bitwise equal to `aggregate_paths` (tests/test_sgm_gpu.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["aggregate_paths_gpu"]

_BIG = 1e9
_BLOCK_LINES = 8      # scan lines per program
_NUM_WARPS = 4


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _shift_d(x: jnp.ndarray, up: bool) -> jnp.ndarray:
    """x[..., d-1] (``up``) or x[..., d+1] along the last axis, +BIG fill.

    Triton has no slice of a register tensor, so the shift recurses over
    the even/odd interleave: shift(x)[2j] and shift(x)[2j+1] are one
    shifted half and one unshifted half, and a length-1 shift is the
    fill alone."""
    n = x.shape[-1]
    if n == 1:
        return jnp.full_like(x, _BIG)
    half = x.shape[:-1] + (n // 2,)
    even, odd = jax.lax.split(x.reshape(half + (2,)), (1, 1), axis=x.ndim)
    if up:      # out[2j] = x[2j-1] = odd[j-1]; out[2j+1] = even[j]
        lo = _shift_d(odd.reshape(half), True).reshape(half + (1,))
        hi = even
    else:       # out[2j] = odd[j]; out[2j+1] = x[2j+2] = even[j+1]
        lo = odd
        hi = _shift_d(even.reshape(half), False).reshape(half + (1,))
    return jnp.concatenate([lo, hi], axis=-1).reshape(x.shape)


def _direction_kernel(c_ref, s_in_ref, s_ref, *, H, W, D, Dp, BM, kind,
                      sx, reverse, n_lines, P1, P2):
    """Adds one direction's L into S for this program's block of lines.

    kind 'h': lines are rows, the walk runs over x. kind 'v': the walk
    runs over y and line k sits at x = k + sx*y (sx = 0 vertical, ±1
    diagonal)."""
    del s_in_ref  # aliased to s_ref
    pid = pl.program_id(0)
    line = pid * BM + jnp.arange(BM, dtype=jnp.int32)
    d = jnp.arange(Dp, dtype=jnp.int32)
    fresh = jnp.where(d < D, 0.0, _BIG).astype(jnp.float32)[None, :]
    fresh = jnp.broadcast_to(fresh, (BM, Dp))
    n_steps = W if kind == "h" else H
    k = line - (H - 1) if (kind == "v" and sx == 1) else line

    def step(t, L_prev):
        u = (n_steps - 1 - t) if reverse else t
        if kind == "h":
            y, x = line, jnp.full_like(line, u)
        else:
            y, x = jnp.full_like(line, u), k + sx * u
        ok = (line < n_lines) & (x >= 0) & (x < W) & (y < H)
        # positions outside the image go to the spare row H*W
        pos = jnp.where(ok, y * W + x, H * W)
        off = pos[:, None] * Dp + d[None, :]
        c = plgpu.load(c_ref.at[off])
        min_prev = jnp.min(L_prev, axis=1, keepdims=True)
        nb = jnp.minimum(_shift_d(L_prev, True), _shift_d(L_prev, False))
        best = jnp.minimum(jnp.minimum(L_prev, min_prev + P2), nb + P1)
        L = jnp.where(ok[:, None], c + best - min_prev, fresh)
        plgpu.store(s_ref.at[off], plgpu.load(s_ref.at[off]) + L)
        return L

    jax.lax.fori_loop(0, n_steps, step, fresh)


def _kernel_name(kind: str, sx: int, reverse: bool) -> str:
    """Stable trace names: sgm_h_fwd, sgm_v_rev, sgm_diagp_fwd, ..."""
    line = {0: kind, 1: "diagp", -1: "diagm"}[sx] if kind == "v" else kind
    return f"sgm_{line}_{'rev' if reverse else 'fwd'}"


def _directions(num_paths: int):
    """(kind, sx, reverse) for each path; the jnp aggregate_paths order."""
    dirs = [("h", 0, False), ("h", 0, True)]
    if num_paths >= 4:
        dirs += [("v", 0, False), ("v", 0, True)]
    if num_paths == 8:
        # down-right / down-left, then the up pass's two diagonals
        dirs += [("v", 1, False), ("v", -1, False),
                 ("v", -1, True), ("v", 1, True)]
    return dirs


@partial(jax.jit, static_argnames=("P1", "P2", "num_paths", "interpret"))
def aggregate_paths_gpu(cost: jnp.ndarray, P1, P2, num_paths: int = 8,
                        interpret: bool = False) -> jnp.ndarray:
    """Sum of the per-path aggregated costs, (H, W, D) float32 — the same
    contract (and bits) as `ops.sgbm.aggregate_paths`."""
    assert num_paths in (2, 4, 8)
    H, W, D = cost.shape
    Dp = _next_pow2(D)
    BM = _BLOCK_LINES
    # (H*W + 1, Dp): +BIG lanes pad D, and one spare row takes the reads
    # and writes of positions outside the image, so no access needs a mask
    c_flat = jnp.pad(cost.astype(jnp.float32).reshape(H * W, D),
                     ((0, 1), (0, Dp - D)), constant_values=_BIG).reshape(-1)
    S = jnp.zeros_like(c_flat)
    for kind, sx, reverse in _directions(num_paths):
        n_lines = H if kind == "h" else (W if sx == 0 else W + H - 1)
        kernel = partial(_direction_kernel, H=H, W=W, D=D, Dp=Dp, BM=BM,
                         kind=kind, sx=sx, reverse=reverse,
                         n_lines=n_lines, P1=float(P1), P2=float(P2))
        S = pl.pallas_call(
            kernel,
            out_shape=jax.ShapeDtypeStruct(S.shape, S.dtype),
            grid=(pl.cdiv(n_lines, BM),),
            input_output_aliases={1: 0},
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                                 num_stages=2),
            interpret=interpret,
            name=_kernel_name(kind, sx, reverse),
        )(c_flat, S)
    return S.reshape(H * W + 1, Dp)[:H * W, :D].reshape(H, W, D)
