"""Sharded SGBM execution over a (frame, tile, disp) device mesh.

The reference has no distributed execution at all (SURVEY.md §2.10); this
module is the scale-out design:

- **frame** axis: data parallelism — frames are independent, zero comms.
- **tile** axis: the H dimension of the (H, W, D) cost volume is sharded.
  Horizontal DP paths are row-local (free). Vertical/diagonal paths carry
  state across tile boundaries; two modes:
    * ``halo`` (default): each tile receives a `halo`-row slab of its
      neighbor's cost volume via `ppermute` and warm-starts the scan from
      the zero state `halo` rows early. SGM's P2 cap + min-normalization
      attenuate the influence of the start state, so a large enough halo
      reproduces the single-device map; `chip_smoke.py --four-cards`
      re-measures the agreement at 1280x720x128 with halo=64, and
      `tools/halo_error.py` sweeps halo sizes. Tile 0 (down pass) / last
      tile (up pass) receive `ppermute`'s zero fill — which IS the exact
      path-start state, so edge tiles are exact.
    * ``exact``: sequential wavefront — tile k runs its scan only after
      receiving tile k-1's final carry (ppermute chain). Bitwise equal to
      single-device, at pipeline-serial latency; used as the correctness
      anchor and for deterministic multi-device == single-device tests.
- **disp** axis: the cost volume's D dimension is sharded — each member
  builds, aggregates, and reduces only its D/n_disp disparity slice, so
  per-device volume memory drops by n_disp. The SGM recurrence couples
  slices two ways, both handled per scan step:
    * the P2 term needs min over the full D axis — `lax.pmin` of the
      local (M, 1) row minimum;
    * the P1 term needs the d±1 neighbors, which cross slice boundaries
      at the edges — one-lane `ppermute` halos (edge members receive the
      ppermute zero-fill, replaced with +inf = the no-neighbor state).
  WTA/uniqueness/subpixel/LR all become local-reduce + packed all-reduce
  min/max combines (`_wta_dshard`, `_lr_check_dshard`) — bitwise equal to
  the single-device path (tested).

All collectives are XLA named-axis ops inside `jax.shard_map`. The
per-step collectives of the halo/exact/disp modes live inside the jnp
scans, so the sharded matcher runs those scans on every supported
platform (`ops.backend.platform` rejects any other).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.backend import platform
from ..ops.reproject import reproject_to_3d
from ..ops.sgbm import (SGBMParams, _dp_update, _shift_w, bt_cost_volume,
                        box_filter_volume, lr_check, sobel_clip,
                        speckle_filter, wta)
from ..ops.wls import wls_disparity_filter
from .mesh import DISP_AXIS, FRAME_AXIS, TILE_AXIS

__all__ = ["sgbm_sharded", "pipeline_step_sharded"]

_BIG = jnp.float32(1e9)


# ---------------------------------------------------------------------------
# local building blocks (operate on a tile's row slab / disp slice)
# ---------------------------------------------------------------------------


def _local_cost_slab(left: jnp.ndarray, right: jnp.ndarray,
                     params: SGBMParams, tile_idx, h_local: int,
                     disp_idx=0, n_disp: int = 1) -> jnp.ndarray:
    """Cost volume rows [tile_idx*h_local, (tile_idx+1)*h_local) for this
    member's D-slice, computed from the replicated full images. The Sobel
    prefilter (±1 row) and box window (±block//2 rows) need context rows,
    so an extended slab is computed and cropped — cheap since images are
    replicated. With n_disp > 1 only D/n_disp disparity planes are built
    (true D-axis memory sharding, SURVEY §2.10)."""
    pad = params.block_size // 2 + 1
    H = left.shape[0]
    start = tile_idx * h_local
    # clamp the extended window to the image; track the crop offset
    # (tile=1 meshes have h_local == H: the slab is the whole image)
    ext_rows = min(h_local + 2 * pad, H)
    ext_start = jnp.maximum(start - pad, 0)
    ext_start = jnp.minimum(ext_start, H - ext_rows)
    lext = jax.lax.dynamic_slice_in_dim(left, ext_start, ext_rows, axis=0)
    rext = jax.lax.dynamic_slice_in_dim(right, ext_start, ext_rows, axis=0)
    lt = sobel_clip(lext, params.pre_filter_cap)
    rt = sobel_clip(rext, params.pre_filter_cap)
    d_local = params.num_disparities // n_disp
    d0 = params.min_disparity + disp_idx * d_local
    C = bt_cost_volume(lt, rt, d_local, d0)
    C = box_filter_volume(C, params.block_size)
    off = start - ext_start
    return jax.lax.dynamic_slice_in_dim(C, off, h_local, axis=0)


def _dp_update_dshard(Lprev: jnp.ndarray, c: jnp.ndarray, P1, P2,
                      n_disp: int, disp_idx) -> jnp.ndarray:
    """SGM step on a D-slice: Lprev/c (M, D_l) local slices.

    Two collectives couple the slices (module docstring): `pmin` for the
    global min over D (P2 term) and one-lane `ppermute` halos for the d±1
    neighbors at slice edges (P1 term). Edge members get ppermute's
    zero-fill, replaced by +inf — exactly the no-neighbor state the
    unsharded update encodes with _BIG. Bitwise equal to _dp_update on
    the concatenated slices."""
    if n_disp == 1:
        return _dp_update(Lprev, c, P1, P2)
    minL = jax.lax.pmin(jnp.min(Lprev, axis=-1, keepdims=True), DISP_AXIS)
    fwd = [(i, i + 1) for i in range(n_disp - 1)]
    bwd = [(i + 1, i) for i in range(n_disp - 1)]
    from_prev = jax.lax.ppermute(Lprev[..., -1:], DISP_AXIS, fwd)
    from_next = jax.lax.ppermute(Lprev[..., :1], DISP_AXIS, bwd)
    big = jnp.full_like(Lprev[..., :1], _BIG)
    from_prev = jnp.where(disp_idx == 0, big, from_prev)
    from_next = jnp.where(disp_idx == n_disp - 1, big, from_next)
    lm1 = jnp.concatenate([from_prev, Lprev[..., :-1]], axis=-1)
    lp1 = jnp.concatenate([Lprev[..., 1:], from_next], axis=-1)
    best = jnp.minimum(jnp.minimum(Lprev, minL + P2),
                       jnp.minimum(lm1, lp1) + P1)
    return c + best - minL


def _wta_dshard(S: jnp.ndarray, params: SGBMParams, n_disp: int, disp_idx
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """WTA + uniqueness + subpixel on a D-sliced (H, W, D_l) volume.

    All-reduce-min combines (SURVEY §2.10 'Disparity-range parallel'):
    global s0 by pmin, argmin by pmin of masked global-d indices (ties ->
    smallest d, matching jnp.argmin), uniqueness by pmax of the local
    violation flag, subpixel neighbors S[d*±1] by pmin of masked values.
    Returns replicated (disp, valid) bitwise equal to ops.sgbm.wta."""
    if n_disp == 1:
        return wta(S, params)
    H, W, Dl = S.shape
    D = Dl * n_disp
    dg = jnp.arange(Dl)[None, None, :] + disp_idx * Dl     # global d
    s0 = jax.lax.pmin(jnp.min(S, axis=-1), DISP_AXIS)      # (H, W)
    d_star = jax.lax.pmin(
        jnp.min(jnp.where(S == s0[..., None], dg, D), axis=-1), DISP_AXIS)

    valid = jnp.ones((H, W), bool)
    if params.uniqueness_ratio > 0:
        thresh = s0 * ((100 + params.uniqueness_ratio) / 100.0)
        far = jnp.abs(dg - d_star[..., None]) > 1
        bad_l = jnp.max(jnp.where(far & (S < thresh[..., None]), 1.0, 0.0),
                        axis=-1)
        valid &= jax.lax.pmax(bad_l, DISP_AXIS) < 0.5

    # subpixel neighbors: the unsharded wta clips d*±1 into [0, D-1] (the
    # clipped value only matters when offset is zeroed at the ends, so
    # reproducing the clip keeps bit parity)
    dm = jnp.clip(d_star - 1, 0, D - 1)[..., None]
    dp = jnp.clip(d_star + 1, 0, D - 1)[..., None]
    sm = jax.lax.pmin(jnp.min(jnp.where(dg == dm, S, _BIG), axis=-1),
                      DISP_AXIS)
    sp = jax.lax.pmin(jnp.min(jnp.where(dg == dp, S, _BIG), axis=-1),
                      DISP_AXIS)
    denom = jnp.maximum(sm + sp - 2.0 * s0, 1e-6)
    offset = jnp.clip((sm - sp) / (2.0 * denom), -0.5, 0.5)
    offset = jnp.where((d_star == 0) | (d_star == D - 1), 0.0, offset)
    disp = d_star + offset + params.min_disparity
    if params.quantize_16:
        disp = jnp.round(disp * 16.0) / 16.0

    xs = jnp.arange(W)[None, :]
    valid &= (d_star + params.min_disparity) <= xs
    return disp.astype(jnp.float32), valid


def _lr_check_dshard(S: jnp.ndarray, disp: jnp.ndarray, valid: jnp.ndarray,
                     params: SGBMParams, n_disp: int, disp_idx
                     ) -> jnp.ndarray:
    """LR-consistency on the D-sliced volume (winner-scatter disp2, same
    spec as lr_check_np): the global per-column winner (s0, d*) comes
    from two pmin rounds over the disp axis (min cost; ties -> min
    global d, matching jnp.argmin), after which the scatter itself is
    local map work, identical on every member."""
    if params.disp12_max_diff < 0:
        return valid
    if n_disp == 1:
        return lr_check(S, disp, valid, params)
    from ..ops.sgbm import _winner_scatter_disp2
    H, W, Dl = S.shape
    D = Dl * n_disp
    dg = jnp.arange(Dl)[None, None, :] + disp_idx * Dl
    s0 = jax.lax.pmin(jnp.min(S, axis=-1), DISP_AXIS)
    d_star = jax.lax.pmin(
        jnp.min(jnp.where(S == s0[..., None], dg, D), axis=-1), DISP_AXIS)
    disp2 = _winner_scatter_disp2(s0.astype(jnp.int32),
                                  d_star.astype(jnp.int32), D,
                                  params.min_disparity)

    xr = (jnp.arange(W)[None, :]
          - jnp.round(disp).astype(jnp.int32)).astype(jnp.int32)
    xr_ok = (xr >= 0) & (xr <= W - 1)
    d2 = jnp.take_along_axis(disp2, jnp.clip(xr, 0, W - 1), axis=1)
    consistent = (d2 >= 0) & (jnp.abs(d2 - disp) <= params.disp12_max_diff)
    return valid & jnp.where(xr_ok, consistent, True)


def _scan_h(cost: jnp.ndarray, P1, P2, reverse: bool,
            update=None) -> jnp.ndarray:
    """Horizontal path (row-local): scan over W with (H_local, D_l) carry."""
    cw = jnp.swapaxes(cost, 0, 1)
    update = update or _dp_update

    def step(carry, c):
        L = update(carry, c, P1, P2)
        return L, L

    z = jnp.zeros((cost.shape[0], cost.shape[2]), jnp.float32)
    _, L = jax.lax.scan(step, z, cw, reverse=reverse)
    return jnp.swapaxes(L, 0, 1)


def _scan_v(cost_ext: jnp.ndarray, P1, P2, reverse: bool,
            keep: int, with_diag: bool, update=None) -> jnp.ndarray:
    """Vertical (+diagonal) pass over an extended slab; returns the last
    (`reverse=False`) or first (`reverse=True`) `keep` rows of the summed
    path volumes."""
    W, D = cost_ext.shape[1], cost_ext.shape[2]
    update = update or _dp_update

    def step(carry, c):
        if with_diag:
            pv, pdr, pdl = carry
            Lv = update(pv, c, P1, P2)
            # for the up pass the diagonals run (-1,+1)/(-1,-1): the shift
            # direction relative to scan order is the same
            Ldr = update(_shift_w(pdr, +1), c, P1, P2)
            Ldl = update(_shift_w(pdl, -1), c, P1, P2)
            return (Lv, Ldr, Ldl), Lv + Ldr + Ldl
        Lv = update(carry, c, P1, P2)
        return Lv, Lv

    z = jnp.zeros((W, D), jnp.float32)
    init = (z, z, z) if with_diag else z
    _, S = jax.lax.scan(step, init, cost_ext, reverse=reverse)
    if reverse:
        return S[:keep]
    return S[S.shape[0] - keep:]


def _aggregate_tile_halo(cost: jnp.ndarray, params: SGBMParams,
                         halo: int, num_paths: int,
                         n_tile: int, n_disp: int, disp_idx
                         ) -> jnp.ndarray:
    """Tile/disp-sharded aggregation, halo mode. `cost` is the local
    (h_local, W, D_l) slab; the full 8/4/2-path sum of this member's
    slab is returned (the D-slice collectives live inside the update)."""
    P1, P2 = jnp.float32(params.P1), jnp.float32(params.P2)
    h_local = cost.shape[0]
    halo = min(halo, h_local)
    with_diag = num_paths == 8
    upd = partial(_dp_update_dshard, n_disp=n_disp, disp_idx=disp_idx)

    S = (_scan_h(cost, P1, P2, reverse=False, update=upd)
         + _scan_h(cost, P1, P2, reverse=True, update=upd))
    if num_paths == 2:
        return S

    if n_tile > 1:
        fwd = [(i, i + 1) for i in range(n_tile - 1)]
        bwd = [(i + 1, i) for i in range(n_tile - 1)]
        prev_slab = jax.lax.ppermute(cost[h_local - halo:], TILE_AXIS, fwd)
        next_slab = jax.lax.ppermute(cost[:halo], TILE_AXIS, bwd)
        down_ext = jnp.concatenate([prev_slab, cost], axis=0)
        up_ext = jnp.concatenate([cost, next_slab], axis=0)
    else:
        down_ext = cost
        up_ext = cost

    S = S + _scan_v(down_ext, P1, P2, reverse=False, keep=h_local,
                    with_diag=with_diag, update=upd)
    S = S + _scan_v(up_ext, P1, P2, reverse=True, keep=h_local,
                    with_diag=with_diag, update=upd)
    return S


def _aggregate_tile_exact(cost: jnp.ndarray, params: SGBMParams,
                          num_paths: int, n_tile: int,
                          n_disp: int = 1, disp_idx=0) -> jnp.ndarray:
    """Exact sequential-wavefront aggregation.

    Tile k's vertical scan starts from tile k-1's final carries, chained
    with ppermute; bitwise-identical to the single-device scan. Composes
    with D-slice sharding (the dshard update's collectives run inside the
    wavefront's scans uniformly on every member, so control flow never
    diverges)."""
    P1, P2 = jnp.float32(params.P1), jnp.float32(params.P2)
    h_local, W, D = cost.shape
    with_diag = num_paths == 8
    upd = partial(_dp_update_dshard, n_disp=n_disp, disp_idx=disp_idx)

    S = _scan_h(cost, P1, P2, reverse=False, update=upd) + \
        _scan_h(cost, P1, P2, reverse=True, update=upd)
    if num_paths == 2:
        return S

    def step(carry, c):
        if with_diag:
            pv, pdr, pdl = carry
            Lv = upd(pv, c, P1, P2)
            Ldr = upd(_shift_w(pdr, +1), c, P1, P2)
            Ldl = upd(_shift_w(pdl, -1), c, P1, P2)
            return (Lv, Ldr, Ldl), Lv + Ldr + Ldl
        Lv = upd(carry, c, P1, P2)
        return Lv, Lv

    z = jnp.zeros((W, D), jnp.float32)
    zc = (z, z, z) if with_diag else z
    my = jax.lax.axis_index(TILE_AXIS)
    fwd = [(i, i + 1) for i in range(n_tile - 1)]
    bwd = [(i + 1, i) for i in range(n_tile - 1)]

    def wavefront(scan_rev, perm):
        carry_in = zc
        out = jnp.zeros_like(cost)
        for k in range(n_tile):
            turn = (n_tile - 1 - k) if scan_rev else k
            fin, Sv = jax.lax.scan(step, carry_in, cost, reverse=scan_rev)
            active = my == turn
            out = jnp.where(active, Sv, out)
            keep = jax.tree.map(
                lambda f, c: jnp.where(active, f, c), fin, carry_in)
            carry_in = jax.tree.map(
                lambda x: jax.lax.ppermute(x, TILE_AXIS, perm), keep)
        return out

    S = S + wavefront(False, fwd) + wavefront(True, bwd)
    return S


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def sgbm_sharded(left, right, params: SGBMParams, mesh: Mesh,
                 halo: int = 32, exact: bool = False,
                 apply_speckle: bool = True):
    """Single-pair SGBM sharded over the mesh's (tile, disp) axes.

    Images are replicated; the cost volume and all DP state are sharded —
    rows over the tile axis, disparity planes over the disp axis (each
    member holds an (h_local, W, D/n_disp) slice; both axes reduce
    per-device memory). ``exact`` wavefront mode composes with D-sharding
    and is bitwise-identical to the single-device run. Returns a
    fully-replicated (H, W) float32 disparity map (invalid -1).
    """
    n_tile = mesh.shape[TILE_AXIS]
    n_disp = mesh.shape[DISP_AXIS]
    H, W = left.shape
    assert H % n_tile == 0, f"H={H} must divide tile axis {n_tile}"
    assert params.num_disparities % n_disp == 0
    h_local = H // n_tile
    platform()

    def impl(l, r):
        tile_idx = jax.lax.axis_index(TILE_AXIS)
        disp_idx = jax.lax.axis_index(DISP_AXIS)
        C = _local_cost_slab(l, r, params, tile_idx, h_local,
                             disp_idx, n_disp)
        if exact:
            S = _aggregate_tile_exact(C, params, params.num_paths,
                                      n_tile, n_disp, disp_idx)
        else:
            S = _aggregate_tile_halo(C, params, halo, params.num_paths,
                                     n_tile, n_disp, disp_idx)
        disp, valid = _wta_dshard(S, params, n_disp, disp_idx)
        if params.disp12_max_diff >= 0:
            valid = _lr_check_dshard(S, disp, valid, params, n_disp,
                                     disp_idx)
        disp = jnp.where(valid, disp, -1.0)
        # assemble the full map (all_gather over tile; replicate over disp)
        full = jax.lax.all_gather(disp, TILE_AXIS, axis=0, tiled=True)
        return full

    fn = jax.shard_map(impl, mesh=mesh, check_vma=False,
                       in_specs=(P(), P()),
                       out_specs=P())
    disp = fn(jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32))
    if apply_speckle and params.speckle_window_size > 0:
        valid = speckle_filter(disp, disp >= 0, params.speckle_window_size,
                               params.speckle_range)
        disp = jnp.where(valid, disp, -1.0)
    return disp


def pipeline_step_sharded(lefts, rights, rig_Q, params: SGBMParams,
                          mesh: Mesh, halo: int = 32,
                          scale: float = 1.0, use_wls: bool = False, rects=None,
                          apply_speckle: bool = False):
    """Batched frames over the full (frame, tile, disp) mesh — the
    multi-chip equivalent of the reference's full per-frame hot loop
    (rectify -> SGBM (x2 with WLS) -> post-filter -> reproject,
    stereo_displayer.cpp:145-198; SURVEY.md §2.10 table):

    - frames are data-parallel; each frame's cost volume/DP state is
      tile/disp-sharded;
    - ``rects`` (optional (RemapGrid, RemapGrid)) rectifies the
      replicated eyes before matching;
    - ``use_wls`` adds the right matcher (mirrored inputs, sharded the
      same way — W is unsharded so the flip is local) and the WLS filter;
    - WLS/speckle run on the gathered full map, replicated across a
      frame's (tile, disp) members: those members hold no other frame to
      work on, so replication costs no wall-clock and saves a re-shard.

    lefts/rights: (N, H, W) float32. Returns dict with (N, H, W) disparity
    and (N, H, W, 3) xyz, sharded over the frame axis.
    """
    from ..ops.remap import remap_bilinear

    n_frame = mesh.shape[FRAME_AXIS]
    n_tile = mesh.shape[TILE_AXIS]
    n_disp = mesh.shape[DISP_AXIS]
    N, H, W = lefts.shape
    assert N % n_frame == 0 and H % n_tile == 0
    h_local = H // n_tile
    platform()
    import numpy as np
    Qj = np.asarray(rig_Q, np.float64)

    def match(l, r, tile_idx, disp_idx):
        """Tile/disp-sharded matcher -> full (H, W) disparity map."""
        C = _local_cost_slab(l, r, params, tile_idx, h_local,
                             disp_idx, n_disp)
        S = _aggregate_tile_halo(C, params, halo, params.num_paths,
                                 n_tile, n_disp, disp_idx)
        disp, valid = _wta_dshard(S, params, n_disp, disp_idx)
        valid = _lr_check_dshard(S, disp, valid, params, n_disp,
                                 disp_idx)
        disp = jnp.where(valid, disp, -1.0)
        return jax.lax.all_gather(disp, TILE_AXIS, axis=0, tiled=True)

    def one_pair(l, r):
        tile_idx = jax.lax.axis_index(TILE_AXIS)
        disp_idx = jax.lax.axis_index(DISP_AXIS)
        if rects is not None:
            l = remap_bilinear(l, rects[0])
            r = remap_bilinear(r, rects[1])
        disp = match(l, r, tile_idx, disp_idx)
        if use_wls:
            # ximgproc right-matcher construction (sgbm.py
            # compute_disparity_pair): left matcher on mirrored swapped
            # eyes, then un-mirror
            disp_r = match(r[:, ::-1], l[:, ::-1], tile_idx,
                           disp_idx)[:, ::-1]
            disp, _ = wls_disparity_filter(disp, disp_r, l)
        if apply_speckle and params.speckle_window_size > 0:
            valid = speckle_filter(disp, disp >= 0,
                                   params.speckle_window_size,
                                   params.speckle_range)
            disp = jnp.where(valid, disp, -1.0)
        # reproject the tile-local rows (global row offsets), re-gather
        local = jax.lax.dynamic_slice_in_dim(disp, tile_idx * h_local,
                                             h_local, axis=0)
        xyz = reproject_to_3d(local, Qj, scale=scale,
                              row_offset=tile_idx * h_local)
        xyz_full = jax.lax.all_gather(xyz, TILE_AXIS, axis=0, tiled=True)
        return disp, xyz_full

    def impl(ls, rs):
        return jax.lax.map(lambda lr: one_pair(*lr), (ls, rs))

    fn = jax.shard_map(impl, mesh=mesh, check_vma=False,
                       in_specs=(P(FRAME_AXIS), P(FRAME_AXIS)),
                       out_specs=(P(FRAME_AXIS), P(FRAME_AXIS)))
    disp, xyz = fn(jnp.asarray(lefts, jnp.float32),
                   jnp.asarray(rights, jnp.float32))
    return {"disparity": disp, "xyz": xyz}
