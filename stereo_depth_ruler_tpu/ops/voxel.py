"""Voxel-grid downsampling of point clouds — static-shape, jit-friendly.

Counterpart of the reference's PCL ``VoxelGrid`` stage
(point_cloud/src/pcd_write.cpp:123-130, leaf 0.005): replaces the dynamic
hash-map centroid accumulation with a sort-based segment mean that keeps
every shape static so the whole reduction jits on device:

1. quantize XYZ to integer voxel coordinates (floor(p / leaf));
2. build a single lexicographic key per voxel, sort points by key;
3. mark segment starts, form dense segment ids with a cumsum;
4. `segment_sum` positions/colors + counts (capacity = N, static);
5. divide -> per-voxel centroids; `count` reports how many are real.

Invalid points (NaN/inf) sort to the end under key INT64_MAX and are
excluded. Returns fixed-capacity arrays + the true voxel count, so the
host slices [:count] when exporting.

Unit quirk (SURVEY.md §2.7): the reference passes leaf=0.005 to PCL while
its clouds are in millimetres — literally a 5 µm grid that downsamples
nothing (README calls it "5 mm"). ``leaf`` here is in the cloud's units;
callers wanting reference-quirk behavior pass 0.005, callers wanting the
documented intent pass 5.0 (mm).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["voxel_downsample"]


def voxel_downsample(xyz: jnp.ndarray, rgb: jnp.ndarray | None,
                     leaf: float) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(N, 3) points (+ optional (N, 3) colors) -> voxel centroids.

    Returns (points (N, 3), colors (N, 3) or zeros, count scalar). Entries
    past ``count`` are zero-padding. Matches PCL VoxelGrid centroid
    semantics (mean of members per occupied voxel).
    """
    xyz = jnp.asarray(xyz, jnp.float32)
    n = xyz.shape[0]
    finite = jnp.isfinite(xyz).all(axis=1)
    safe = jnp.where(finite[:, None], xyz, 0.0)
    coords = jnp.floor(safe / leaf).astype(jnp.int32)
    # int64 is unavailable without x64 mode; sort lexicographically over
    # the 3 int32 coords (invalid points get INT32_MAX -> sort last)
    big = jnp.iinfo(jnp.int32).max
    kx = jnp.where(finite, coords[:, 0], big)
    ky = jnp.where(finite, coords[:, 1], big)
    kz = jnp.where(finite, coords[:, 2], big)
    order = jnp.lexsort((kz, ky, kx))
    ks = jnp.stack([kx, ky, kz], axis=1)[order]
    xyz_s = safe[order]          # zeroed invalids: inf*0 would make NaNs
    valid_s = finite[order]

    starts = jnp.concatenate(
        [jnp.array([True]), jnp.any(ks[1:] != ks[:-1], axis=1)])
    seg = jnp.cumsum(starts.astype(jnp.int32)) - 1          # dense ids

    ones = valid_s.astype(jnp.float32)
    counts = jax.ops.segment_sum(ones, seg, num_segments=n)
    sums = jax.ops.segment_sum(xyz_s * ones[:, None], seg, num_segments=n)
    denom = jnp.maximum(counts, 1.0)[:, None]
    centroids = sums / denom

    if rgb is not None:
        rgb = jnp.asarray(rgb, jnp.float32)
        rgb_s = rgb[order]
        csum = jax.ops.segment_sum(rgb_s * ones[:, None], seg,
                                   num_segments=n)
        colors = csum / denom
    else:
        colors = jnp.zeros_like(centroids)

    count = jnp.sum((counts > 0).astype(jnp.int32))
    return centroids, colors, count
