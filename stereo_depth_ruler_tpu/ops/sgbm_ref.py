"""Pure-NumPy SGBM oracle — slow, loop-explicit, spec-defining.

This module pins the *exact* semantics of the framework's semi-global
matcher so the JAX implementations (ops/sgbm.py, ops/sgm_gpu.py)
can be tested for bit-identical agreement on tiny images. The semantics are
modeled on OpenCV's StereoSGBM — the matcher the reference constructs with
(minDisparity=0, numDisparities=80, blockSize=5, P1=600, P2=2400,
disp12MaxDiff=1, preFilterCap=63, uniquenessRatio=12,
speckleWindowSize=200, speckleRange=2, MODE_SGBM_3WAY) at
stereo_vision/src/stereo_disparity.cpp:5-9 — but this framework defaults to
full 8-path aggregation (the BASELINE.json north star) and exposes the path
count as a parameter.

Spec decisions (documented per SURVEY.md hard-part #3/#4):
- Pixel cost: Birchfield–Tomasi on the x-Sobel-prefiltered, clipped image
  (tab = clip(sobel, ±preFilterCap) + preFilterCap), symmetric min form.
- Right coordinates x-d < 0 sample the replicated border column; after WTA a
  pixel is invalidated when its winning d > x (physically impossible match).
  Like OpenCV, this leaves an unreliable band of width ~numDisparities at
  the left edge — which the reference itself excludes from depth coverage
  (stereo_displayer.cpp:107).
- Aggregation: L_r(p,d) = C(p,d) + min(L_r(p-r,d), L_r(p-r,d∓1)+P1,
  min_d' L_r(p-r,d') + P2) − min_d' L_r(p-r,d'); missing predecessor ≡ 0.
- Invalid disparity = -1.0 in the float output (reference converts CV_16S/16
  so invalid (minD-1)*16 becomes -1.0, stereo_disparity.cpp:33-34).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["SGBMParams", "sgbm_numpy", "sobel_clip_np", "bt_cost_volume_np",
           "box_filter_volume_np", "aggregate_np", "wta_np",
           "lr_check_np", "speckle_filter_np",
           "PATH_DIRS_8", "PATH_DIRS_4", "PATH_DIRS_2"]

PATH_DIRS_8 = [(0, 1), (0, -1), (1, 0), (-1, 0),
               (1, 1), (1, -1), (-1, 1), (-1, -1)]
PATH_DIRS_4 = [(0, 1), (0, -1), (1, 0), (-1, 0)]
PATH_DIRS_2 = [(0, 1), (0, -1)]


@dataclasses.dataclass(frozen=True)
class SGBMParams:
    """Matcher parameters; defaults mirror the reference's operating point
    (stereo_disparity.cpp:5-9) except num_paths (8-path per north star)."""
    min_disparity: int = 0
    num_disparities: int = 80
    block_size: int = 5
    p1: Optional[int] = None          # default 8 * cn * block^2 (cn=3)
    p2: Optional[int] = None          # default 32 * cn * block^2
    disp12_max_diff: int = 1
    pre_filter_cap: int = 63
    uniqueness_ratio: int = 12
    speckle_window_size: int = 200
    speckle_range: int = 2
    num_paths: int = 8
    quantize_16: bool = True          # emulate CV_16S/16 output quantization

    @property
    def P1(self) -> int:
        return self.p1 if self.p1 is not None else 8 * 3 * self.block_size ** 2

    @property
    def P2(self) -> int:
        return self.p2 if self.p2 is not None else 32 * 3 * self.block_size ** 2

    @property
    def path_dirs(self):
        return {8: PATH_DIRS_8, 4: PATH_DIRS_4, 2: PATH_DIRS_2}[self.num_paths]


def sobel_clip_np(img: np.ndarray, cap: int) -> np.ndarray:
    """3x3 x-Sobel, clipped to ±cap then shifted to [0, 2*cap].

    Border: replicate (rows and cols clamped)."""
    img = img.astype(np.int32)
    p = np.pad(img, 1, mode="edge")
    gx = (2 * (p[1:-1, 2:] - p[1:-1, :-2])
          + (p[:-2, 2:] - p[:-2, :-2])
          + (p[2:, 2:] - p[2:, :-2]))
    return (np.clip(gx, -cap, cap) + cap).astype(np.int32)


def _bt_terms(row: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel (Imin, Imax) over half-sample neighborhood (BT)."""
    v = row.astype(np.float64)
    vm = np.empty_like(v)
    vp = np.empty_like(v)
    vm[1:] = 0.5 * (v[1:] + v[:-1])
    vm[0] = v[0]
    vp[:-1] = 0.5 * (v[:-1] + v[1:])
    vp[-1] = v[-1]
    imin = np.minimum(np.minimum(vm, vp), v)
    imax = np.maximum(np.maximum(vm, vp), v)
    return imin, imax


def bt_cost_volume_np(left: np.ndarray, right: np.ndarray,
                      num_disp: int, min_disp: int = 0) -> np.ndarray:
    """Birchfield–Tomasi cost volume (H, W, D) float64 (exact integers *2).

    Costs are doubled (like half-sample math done at integer scale) to stay
    integral; right x-coordinates clamp to column 0 (replicate border).
    """
    H, W = left.shape
    D = num_disp
    cost = np.zeros((H, W, D), np.float64)
    for y in range(H):
        lmin, lmax = _bt_terms(left[y])
        rmin, rmax = _bt_terms(right[y])
        lv = left[y].astype(np.float64)
        rv = right[y].astype(np.float64)
        for d_i in range(D):
            d = d_i + min_disp
            xr = np.clip(np.arange(W) - d, 0, W - 1)
            c_lr = np.maximum(0, np.maximum(lv - rmax[xr], rmin[xr] - lv))
            c_rl = np.maximum(0, np.maximum(rv[xr] - lmax, lmin - rv[xr]))
            cost[y, :, d_i] = 2.0 * np.minimum(c_lr, c_rl)
    return cost


def box_filter_volume_np(cost: np.ndarray, block: int) -> np.ndarray:
    """Sum over block x block window, replicate border."""
    r = block // 2
    H, W, D = cost.shape
    p = np.pad(cost, ((r, r), (r, r), (0, 0)), mode="edge")
    out = np.zeros_like(cost)
    for dy in range(block):
        for dx in range(block):
            out += p[dy:dy + H, dx:dx + W, :]
    return out


def aggregate_np(cost: np.ndarray, P1: float, P2: float,
                 dirs) -> np.ndarray:
    """8/4/2-path semi-global aggregation, explicit loops (spec-level)."""
    H, W, D = cost.shape
    S = np.zeros_like(cost)
    for (dy, dx) in dirs:
        L = np.zeros((H, W, D), np.float64)
        ys = range(H) if dy >= 0 else range(H - 1, -1, -1)
        xs = range(W) if dx >= 0 else range(W - 1, -1, -1)
        for y in ys:
            for x in xs:
                py, px = y - dy, x - dx
                if 0 <= py < H and 0 <= px < W:
                    Lp = L[py, px]
                    minLp = Lp.min()
                    lm1 = np.empty(D)
                    lm1[0] = np.inf
                    lm1[1:] = Lp[:-1]
                    lp1 = np.empty(D)
                    lp1[-1] = np.inf
                    lp1[:-1] = Lp[1:]
                    best = np.minimum(
                        np.minimum(Lp, minLp + P2),
                        np.minimum(lm1 + P1, lp1 + P1))
                    L[y, x] = cost[y, x] + best - minLp
                else:
                    L[y, x] = cost[y, x]
        S += L
    return S


def wta_np(S: np.ndarray, params: SGBMParams
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Winner-take-all + uniqueness + subpixel.

    Returns (disp float, valid bool). disp includes min_disparity offset and
    subpixel refinement; validity excludes uniqueness failures and
    physically impossible d > x matches.
    """
    H, W, D = S.shape
    d_star = S.argmin(axis=2)
    s0 = np.take_along_axis(S, d_star[..., None], axis=2)[..., 0]

    # uniqueness: any d with |d - d*| > 1 and S(d)*100 < s0*(100+ratio)?
    valid = np.ones((H, W), bool)
    if params.uniqueness_ratio > 0:
        thresh = s0 * (100 + params.uniqueness_ratio) / 100.0
        ds = np.arange(D)
        far = np.abs(ds[None, None, :] - d_star[..., None]) > 1
        bad = (S < thresh[..., None]) & far
        valid &= ~bad.any(axis=2)

    # subpixel parabola
    dm = np.clip(d_star - 1, 0, D - 1)
    dp = np.clip(d_star + 1, 0, D - 1)
    sm = np.take_along_axis(S, dm[..., None], axis=2)[..., 0]
    sp = np.take_along_axis(S, dp[..., None], axis=2)[..., 0]
    denom = np.maximum(sm + sp - 2 * s0, 1e-6)
    offset = np.clip((sm - sp) / (2 * denom), -0.5, 0.5)
    offset = np.where((d_star == 0) | (d_star == D - 1), 0.0, offset)
    disp = d_star + offset + params.min_disparity
    if params.quantize_16:
        disp = np.round(disp * 16.0) / 16.0

    # physically impossible: winning d exceeds pixel x
    xs = np.arange(W)[None, :]
    valid &= (d_star + params.min_disparity) <= xs
    return disp, valid


def lr_check_np(S: np.ndarray, disp: np.ndarray, valid: np.ndarray,
                params: SGBMParams) -> np.ndarray:
    """Left-right consistency from the left aggregated costs — OpenCV's
    internal disp2 construction (stereosgbm.cpp computeDisparitySGBM):
    each column x scatters only its WTA winner (minS, bestD) to
    x_r = x - bestD - minD, keeping the lower cost on collisions with
    strict '<' (so the first writer — the smallest d for a given x_r —
    wins ties); pixels invalidate when disp2 at x − round(d_l) is absent
    or differs by more than disp12MaxDiff."""
    if params.disp12_max_diff < 0:
        return valid
    H, W, D = S.shape
    md = params.min_disparity
    out = valid.copy()
    for y in range(H):
        disp2 = np.full(W, -1.0)
        cost2 = np.full(W, np.inf)
        for x in range(W):
            d = int(S[y, x].argmin())          # winner only (pre-validity)
            s0 = S[y, x, d]
            xr = x - d - md
            if 0 <= xr < W and s0 < cost2[xr]:
                cost2[xr] = s0
                disp2[xr] = d + md
        for x in range(W):
            if not out[y, x]:
                continue
            d = disp[y, x]
            xr = x - int(np.round(d))
            if 0 <= xr < W:
                if disp2[xr] < 0 or abs(disp2[xr] - d) > params.disp12_max_diff:
                    out[y, x] = False
    return out


def speckle_filter_np(disp: np.ndarray, valid: np.ndarray,
                      max_size: int, max_diff: float) -> np.ndarray:
    """Connected-component speckle removal (cv::filterSpeckles semantics):
    4-connected components where neighbor disparities differ by ≤ max_diff;
    components with ≤ max_size pixels are invalidated."""
    H, W = disp.shape
    labels = -np.ones((H, W), np.int64)
    out = valid.copy()
    cur = 0
    for y0 in range(H):
        for x0 in range(W):
            if not valid[y0, x0] or labels[y0, x0] >= 0:
                continue
            stack = [(y0, x0)]
            labels[y0, x0] = cur
            comp = []
            while stack:
                y, x = stack.pop()
                comp.append((y, x))
                for ny, nx in ((y-1, x), (y+1, x), (y, x-1), (y, x+1)):
                    if 0 <= ny < H and 0 <= nx < W and valid[ny, nx] \
                            and labels[ny, nx] < 0 \
                            and abs(disp[ny, nx] - disp[y, x]) <= max_diff:
                        labels[ny, nx] = cur
                        stack.append((ny, nx))
            if len(comp) <= max_size:
                for y, x in comp:
                    out[y, x] = False
            cur += 1
    return out


def sgbm_numpy(left: np.ndarray, right: np.ndarray,
               params: SGBMParams = SGBMParams(),
               apply_lr: bool = True,
               apply_speckle: bool = True) -> np.ndarray:
    """Full oracle pipeline -> float disparity, invalid = -1.0."""
    cap = params.pre_filter_cap
    lt = sobel_clip_np(left, cap)
    rt = sobel_clip_np(right, cap)
    C = bt_cost_volume_np(lt, rt, params.num_disparities,
                          params.min_disparity)
    C = box_filter_volume_np(C, params.block_size)
    S = aggregate_np(C, params.P1, params.P2, params.path_dirs)
    disp, valid = wta_np(S, params)
    if apply_lr:
        valid = lr_check_np(S, disp, valid, params)
    if apply_speckle and params.speckle_window_size > 0:
        valid = speckle_filter_np(disp, valid, params.speckle_window_size,
                                  params.speckle_range)
    return np.where(valid, disp, -1.0).astype(np.float32)
