"""Semi-global matching in JAX — the framework's reference device path.

Re-design of the matcher the reference builds from OpenCV
(cv::StereoSGBM + ximgproc right matcher, stereo_disparity.cpp:4-14): the
(H, W, D) cost volume keeps D (80/128/256) as the minor, contiguous axis,
and the directional dynamic programming is expressed as `lax.scan`s whose
per-step state is a whole image row/column of disparity vectors:

- horizontal paths scan over W with an (H, D) carry (rows vectorized);
- vertical *and both diagonal* paths share one top->bottom scan over H with
  (W, D) carries, diagonals realized by shifting the carry ±1 along W per
  row (a path-start "fresh" state enters from the border, encoded as the
  zero vector — min(0, 0+P1, 0+P2) − 0 = 0 makes L = C exactly);
- the bottom->up scan mirrors it, so 8 paths cost 4 volume traversals.

Everything here is jit-compatible with static shapes; semantics are pinned
bit-for-bit by the NumPy oracle in ops/sgbm_ref.py (see its docstring for
the spec decisions). On the GPU the aggregation runs as the Triton kernel
in ops/sgm_gpu.py (chosen by ops/backend.py), bitwise equal to
`aggregate_paths`; this module is its correctness anchor and the CPU
path.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .sgbm_ref import SGBMParams  # shared parameter dataclass

__all__ = ["SGBMParams", "sobel_clip", "bt_cost_volume", "box_filter_volume",
           "aggregate_paths", "wta", "lr_check", "speckle_filter", "sgbm",
           "compute_disparity_pair"]

_BIG = jnp.float32(1e9)


def sobel_clip(img: jnp.ndarray, cap: int) -> jnp.ndarray:
    """3x3 x-Sobel clipped to [0, 2*cap] (preFilterCap semantics,
    OpenCV tab[] prefilter). Replicate border. img: (H, W) any real dtype.

    The image is truncated to int32 first (matching sobel_clip_np and
    OpenCV's uint8 input), so the output — and every downstream cost/DP
    value — is an exact small integer (so float32 sums are exact in any
    order)."""
    img = img.astype(jnp.int32).astype(jnp.float32)
    p = jnp.pad(img, 1, mode="edge")
    gx = (2.0 * (p[1:-1, 2:] - p[1:-1, :-2])
          + (p[:-2, 2:] - p[:-2, :-2])
          + (p[2:, 2:] - p[2:, :-2]))
    return jnp.clip(gx, -cap, cap) + cap


def _bt_minmax(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    v = img
    vm = jnp.concatenate([v[:, :1], 0.5 * (v[:, 1:] + v[:, :-1])], axis=1)
    vp = jnp.concatenate([0.5 * (v[:, :-1] + v[:, 1:]), v[:, -1:]], axis=1)
    imin = jnp.minimum(jnp.minimum(vm, vp), v)
    imax = jnp.maximum(jnp.maximum(vm, vp), v)
    return imin, imax


def bt_cost_volume(left: jnp.ndarray, right: jnp.ndarray, num_disp: int,
                   min_disp: int = 0) -> jnp.ndarray:
    """Birchfield–Tomasi cost volume (H, W, D) float32 (doubled, integral).

    Right x-coordinates clamp to column 0 (replicate border) — identical to
    bt_cost_volume_np.
    """
    H, W = left.shape
    lmin, lmax = _bt_minmax(left)
    rmin, rmax = _bt_minmax(right)
    xs = jnp.arange(W)[:, None]
    ds = jnp.arange(num_disp)[None, :] + min_disp
    xr = jnp.clip(xs - ds, 0, W - 1)              # (W, D)

    def gather(a):                                 # (H, W) -> (H, W, D)
        return jnp.take(a, xr, axis=1)

    lv = left[:, :, None]
    rv = gather(right)
    c_lr = jnp.maximum(0.0, jnp.maximum(lv - gather(rmax), gather(rmin) - lv))
    c_rl = jnp.maximum(0.0, jnp.maximum(rv - lmax[:, :, None],
                                        lmin[:, :, None] - rv))
    return 2.0 * jnp.minimum(c_lr, c_rl)


def box_filter_volume(cost: jnp.ndarray, block: int) -> jnp.ndarray:
    """block x block window sum over (H, W) axes, replicate border."""
    r = block // 2
    p = jnp.pad(cost, ((r, r), (0, 0), (0, 0)), mode="edge")
    out = sum(p[dy:dy + cost.shape[0]] for dy in range(block))
    p = jnp.pad(out, ((0, 0), (r, r), (0, 0)), mode="edge")
    out = sum(p[:, dx:dx + cost.shape[1]] for dx in range(block))
    return out


def _dp_update(Lprev: jnp.ndarray, c: jnp.ndarray,
               P1: float, P2: float) -> jnp.ndarray:
    """One SGM step: Lprev (M, D) predecessor, c (M, D) cost -> L (M, D)."""
    minL = jnp.min(Lprev, axis=-1, keepdims=True)
    lm1 = jnp.concatenate([jnp.full_like(Lprev[..., :1], _BIG),
                           Lprev[..., :-1]], axis=-1)
    lp1 = jnp.concatenate([Lprev[..., 1:],
                           jnp.full_like(Lprev[..., :1], _BIG)], axis=-1)
    best = jnp.minimum(jnp.minimum(Lprev, minL + P2),
                       jnp.minimum(lm1, lp1) + P1)
    return c + best - minL


def _shift_w(x: jnp.ndarray, direction: int) -> jnp.ndarray:
    """Shift (W, D) carry along W; vacated row becomes the fresh-start zero
    state (path entering from the image border)."""
    z = jnp.zeros_like(x[:1])
    if direction > 0:
        return jnp.concatenate([z, x[:-1]], axis=0)
    return jnp.concatenate([x[1:], z], axis=0)


def aggregate_paths(cost: jnp.ndarray, P1: float, P2: float,
                    num_paths: int = 8) -> jnp.ndarray:
    """Sum of per-path aggregated costs S = Σ_r L_r, (H, W, D) float32."""
    assert num_paths in (2, 4, 8)
    H, W, D = cost.shape
    P1 = jnp.float32(P1)
    P2 = jnp.float32(P2)

    # --- horizontal paths: scan over W, carry (H, D) --------------------
    cw = jnp.swapaxes(cost, 0, 1)                  # (W, H, D)

    def h_step(carry, c):
        L = _dp_update(carry, c, P1, P2)
        return L, L

    z_h = jnp.zeros((H, D), jnp.float32)
    _, L_lr = jax.lax.scan(h_step, z_h, cw)
    _, L_rl = jax.lax.scan(h_step, z_h, cw, reverse=True)
    S = jnp.swapaxes(L_lr + L_rl, 0, 1)

    if num_paths == 2:
        return S

    # --- vertical (+ diagonal) paths: scan over H, carries (W, D) -------
    with_diag = num_paths == 8

    def v_step(carry, c):
        if with_diag:
            pv, pdr, pdl = carry
            Lv = _dp_update(pv, c, P1, P2)
            Ldr = _dp_update(_shift_w(pdr, +1), c, P1, P2)
            Ldl = _dp_update(_shift_w(pdl, -1), c, P1, P2)
            return (Lv, Ldr, Ldl), Lv + Ldr + Ldl
        Lv = _dp_update(carry, c, P1, P2)
        return Lv, Lv

    z = jnp.zeros((W, D), jnp.float32)
    z_v = (z, z, z) if with_diag else z
    _, S_down = jax.lax.scan(v_step, z_v, cost)
    _, S_up = jax.lax.scan(v_step, z_v, cost, reverse=True)
    return S + S_down + S_up


def wta(S: jnp.ndarray, params: SGBMParams
        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Winner-take-all + uniqueness + subpixel -> (disp f32, valid bool).

    Matches wta_np exactly (see its docstring for the rules)."""
    H, W, D = S.shape
    d_star = jnp.argmin(S, axis=-1)
    s0 = jnp.min(S, axis=-1)

    valid = jnp.ones((H, W), bool)
    if params.uniqueness_ratio > 0:
        thresh = s0 * ((100 + params.uniqueness_ratio) / 100.0)
        ds = jnp.arange(D)[None, None, :]
        far = jnp.abs(ds - d_star[..., None]) > 1
        bad = jnp.any((S < thresh[..., None]) & far, axis=-1)
        valid &= ~bad

    dm = jnp.clip(d_star - 1, 0, D - 1)
    dp = jnp.clip(d_star + 1, 0, D - 1)
    sm = jnp.take_along_axis(S, dm[..., None], axis=-1)[..., 0]
    sp = jnp.take_along_axis(S, dp[..., None], axis=-1)[..., 0]
    denom = jnp.maximum(sm + sp - 2.0 * s0, 1e-6)
    offset = jnp.clip((sm - sp) / (2.0 * denom), -0.5, 0.5)
    offset = jnp.where((d_star == 0) | (d_star == D - 1), 0.0, offset)
    disp = d_star + offset + params.min_disparity
    if params.quantize_16:
        disp = jnp.round(disp * 16.0) / 16.0

    xs = jnp.arange(W)[None, :]
    valid &= (d_star + params.min_disparity) <= xs
    return disp.astype(jnp.float32), valid


def _winner_scatter_disp2(s0i: jnp.ndarray, d_star: jnp.ndarray,
                          D: int, min_disp: int) -> jnp.ndarray:
    """disp2 from per-column WTA winners (OpenCV stereosgbm.cpp): winner
    (s0, d*) of column x lands at x_r = x − d* − minD; collisions keep
    the lower cost, ties the smaller d (= OpenCV's ascending-x strict-<
    first-writer). Realized as D masked left-shifts of an int32
    (cost, d)-packed map — no scatter, no volume traffic.

    s0i: (H, W) int32 exact winner costs; d_star: (H, W) int32 argmin.
    Returns (H, W) float32 disp2 (−1 where no winner landed)."""
    H, W = s0i.shape
    md = min_disp
    PK = 1 << int(D + md).bit_length()
    BIGP = jnp.int32(2 ** 30)
    packed = s0i * PK + d_star + md
    disp2p = jnp.full((H, W), BIGP, jnp.int32)
    for d in range(D):
        s = d + md
        cand = jnp.pad(packed[:, s:], ((0, 0), (0, s)),
                       constant_values=2 ** 30) if s else packed
        okm = (cand & (PK - 1)) == s
        disp2p = jnp.minimum(disp2p, jnp.where(okm, cand, BIGP))
    return jnp.where(disp2p < BIGP,
                     (disp2p & (PK - 1)).astype(jnp.float32), -1.0)


def lr_check(S: jnp.ndarray, disp: jnp.ndarray, valid: jnp.ndarray,
             params: SGBMParams) -> jnp.ndarray:
    """Consistency check against the right-view disparity built from the
    per-column WTA winners of the same aggregated volume (OpenCV's
    internal winner-scatter disp2). Matches lr_check_np."""
    if params.disp12_max_diff < 0:
        return valid
    H, W, D = S.shape
    d_star = jnp.argmin(S, axis=-1).astype(jnp.int32)
    s0i = jnp.min(S, axis=-1).astype(jnp.int32)    # exact small ints
    disp2 = _winner_scatter_disp2(s0i, d_star, D, params.min_disparity)

    xr = (jnp.arange(W)[None, :]
          - jnp.round(disp).astype(jnp.int32)).astype(jnp.int32)
    xr_ok = (xr >= 0) & (xr <= W - 1)
    d2 = jnp.take_along_axis(disp2, jnp.clip(xr, 0, W - 1), axis=1)
    consistent = (d2 >= 0) & (jnp.abs(d2 - disp) <= params.disp12_max_diff)
    return valid & jnp.where(xr_ok, consistent, True)


def _segmented_min_scan(vals: jnp.ndarray, conn: jnp.ndarray) -> jnp.ndarray:
    """Min-propagate along the last axis within runs: conn[..., i] True
    means element i is connected to element i-1 (same run). Both
    directions. O(log N) associative scans, no gathers."""

    def combine(a, b):
        va, sa = a
        vb, sb = b
        v = jnp.where(sb, jnp.minimum(va, vb), vb)
        return v, sa & sb   # run continues only if both links unbroken

    n = vals.shape[-1]
    axis = vals.ndim - 1
    fwd = jax.lax.associative_scan(combine, (vals, conn), axis=axis)[0]
    rev = jax.lax.associative_scan(
        combine,
        (vals, jnp.concatenate(
            [conn[..., 1:], jnp.zeros_like(conn[..., :1])], axis=-1)),
        axis=axis, reverse=True)[0]
    return jnp.minimum(fwd, rev)


def speckle_filter(disp: jnp.ndarray, valid: jnp.ndarray,
                   max_size: int, max_diff: float,
                   max_iters: int = 0) -> jnp.ndarray:
    """Connected-component speckle removal (cv::filterSpeckles semantics)
    as iterated segmented min-sweeps — a gather-free CCL.

    Two pixels are connected (4-neighborhood) when both are valid and their
    disparities differ by ≤ max_diff. Labels (min flat-index per component)
    propagate via row- and column-directional segmented min scans
    (associative, O(log) depth, elementwise), iterated **to convergence**
    (`while_loop` on "any label changed"), so the result is the exact
    flood-fill CCL for arbitrarily snaky components. Components with
    ≤ max_size pixels are invalidated.

    Convergence cost is data-dependent: one round fuses labels along any
    monotone row/column chain, so rounds ≈ half the largest number of
    direction turns on a component's geodesic. Measured
    (tests/test_speckle_bound.py): natural synthetic scenes converge in
    ≤ 3 rounds; the adversarial full-image serpentine at H×W needs
    ~H/(2·pitch) rounds (e.g. 16 rounds at 64×96, pitch 2). ``max_iters``
    > 0 caps the rounds for a hard latency ceiling — capped labels can
    only over-split (never merge) components, so a cap may only turn
    "keep" into "filter" for pathological snakes; 0 keeps the exact
    flood-fill default (matches cv::filterSpeckles on every input).
    """
    H, W = disp.shape
    n = H * W
    flat_idx = jnp.arange(n, dtype=jnp.int32).reshape(H, W)
    labels = jnp.where(valid, flat_idx, n).astype(jnp.float32)

    # horizontal connectivity: pixel (y, x) linked to (y, x-1)
    conn_h = jnp.concatenate(
        [jnp.zeros((H, 1), bool),
         valid[:, 1:] & valid[:, :-1]
         & (jnp.abs(disp[:, 1:] - disp[:, :-1]) <= max_diff)], axis=1)
    # vertical connectivity: pixel (y, x) linked to (y-1, x)
    conn_v = jnp.concatenate(
        [jnp.zeros((1, W), bool),
         valid[1:] & valid[:-1]
         & (jnp.abs(disp[1:] - disp[:-1]) <= max_diff)], axis=0)
    conn_vT = conn_v.T

    def body(state):
        lab, _, it = state
        new = _segmented_min_scan(lab, conn_h)
        new = _segmented_min_scan(new.T, conn_vT).T
        return new, jnp.any(new != lab), it + 1

    def cond(state):
        changed = state[1]
        if max_iters > 0:
            return changed & (state[2] < max_iters)
        return changed

    labels, _, _ = jax.lax.while_loop(
        cond, body, (labels, jnp.bool_(True), jnp.int32(0)))
    labels = labels.astype(jnp.int32)

    sizes = jnp.zeros(n + 1, jnp.int32).at[labels.reshape(-1)].add(
        valid.reshape(-1).astype(jnp.int32))
    comp_size = jnp.take(sizes, labels)
    return valid & (comp_size > max_size)


def sgbm(left: jnp.ndarray, right: jnp.ndarray,
         params: SGBMParams = SGBMParams(),
         apply_lr: bool = True, apply_speckle: bool = True,
         aggregator=None) -> jnp.ndarray:
    """Full single-image SGBM -> float32 disparity map, invalid = -1.0.

    `aggregator(cost, P1, P2, num_paths)` is the platform's SGM
    aggregation (ops/backend.select_aggregator); defaults to the lax.scan
    implementation above.
    """
    cap = params.pre_filter_cap
    lt = sobel_clip(left, cap)
    rt = sobel_clip(right, cap)
    C = bt_cost_volume(lt, rt, params.num_disparities, params.min_disparity)
    C = box_filter_volume(C, params.block_size)
    agg = aggregator or aggregate_paths
    S = agg(C, params.P1, params.P2, params.num_paths)
    disp, valid = wta(S, params)
    if apply_lr:
        valid = lr_check(S, disp, valid, params)
    if apply_speckle and params.speckle_window_size > 0:
        valid = speckle_filter(disp, valid, params.speckle_window_size,
                               params.speckle_range)
    return jnp.where(valid, disp, -1.0)


def compute_disparity_pair(left: jnp.ndarray, right: jnp.ndarray,
                           params: SGBMParams = SGBMParams(),
                           aggregator=None
                           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Left and right disparity maps (the reference's matcher + ximgproc
    right matcher pair, stereo_disparity.cpp:26-28). The right matcher is
    the left matcher on horizontally mirrored, swapped inputs — exactly
    cv::ximgproc::createRightMatcher's construction — so right-view
    disparities come out positive here (the reference's are negative and
    sign-flipped inside the WLS filter)."""
    disp_l = sgbm(left, right, params, aggregator=aggregator)
    disp_r_m = sgbm(right[:, ::-1], left[:, ::-1], params,
                    aggregator=aggregator)
    disp_r = disp_r_m[:, ::-1]
    return disp_l, disp_r
