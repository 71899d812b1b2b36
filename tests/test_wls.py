"""WLS / Fast Global Smoother: exact tridiagonal solve vs scipy, smoothing
behavior, confidence-weighted filtering."""

import numpy as np
import pytest

from stereo_depth_ruler_tpu.ops.wls import (fgs_filter, tridiag_solve,
                                            wls_disparity_filter)


def _random_fgs_system(rng, B, N, lam):
    w = rng.random((B, N - 1)).astype(np.float64)
    a = np.zeros((B, N))
    a[:, 1:] = -lam * w
    c = np.zeros((B, N))
    c[:, :-1] = -lam * w
    b = np.ones((B, N))
    b[:, 1:] += lam * w
    b[:, :-1] += lam * w
    d = (rng.random((B, N)) * 100).astype(np.float64)
    return a, b, c, d


# accuracy is f32-conditioning-limited: κ(T) ≈ 2λ, so expected rel err
# ≈ κ·ε_f32; tolerances scale accordingly (λ=8000 → ~1e-3).
@pytest.mark.parametrize("lam,tol", [(10.0, 1e-5), (500.0, 3e-4),
                                     (8000.0, 5e-3)])
def test_tridiag_vs_scipy(lam, tol):
    from scipy.linalg import solve_banded
    rng = np.random.default_rng(0)
    B, N = 4, 257
    a, b, c, d = _random_fgs_system(rng, B, N, lam)
    ours = np.asarray(tridiag_solve(np.float32(a), np.float32(b),
                                    np.float32(c), np.float32(d)))
    for i in range(B):
        ab = np.zeros((3, N))
        ab[0, 1:] = c[i, :-1]
        ab[1] = b[i]
        ab[2, :-1] = a[i, 1:]
        ref = solve_banded((1, 1), ab, d[i])
        rel = np.abs(ours[i] - ref).max() / max(1.0, np.abs(ref).max())
        assert rel < tol, f"lam={lam} row={i} rel={rel}"


def test_fgs_smooths_but_preserves_edges():
    rng = np.random.default_rng(1)
    H, W = 64, 96
    guide = np.zeros((H, W), np.float32)
    guide[:, W // 2:] = 200.0              # strong edge in the guide
    signal = np.where(guide > 0, 30.0, 10.0).astype(np.float32)
    noisy = signal + rng.normal(0, 2.0, (H, W)).astype(np.float32)
    out = np.asarray(fgs_filter(noisy, guide, lam=800.0, sigma_color=1.1))
    # noise suppressed within regions
    assert out[:, :W // 2 - 2].std() < noisy[:, :W // 2 - 2].std() * 0.5
    # edge preserved: region means stay distinct
    assert abs(out[:, :W // 2 - 2].mean() - 10.0) < 1.0
    assert abs(out[:, W // 2 + 2:].mean() - 30.0) < 1.0


def _thomas_np(a, b, c, d):
    """Exact sequential Thomas solve, float64 (reference for the
    associative-scan solver)."""
    n = d.shape[-1]
    cp = np.zeros_like(d)
    dp = np.zeros_like(d)
    cp[..., 0] = c[..., 0] / b[..., 0]
    dp[..., 0] = d[..., 0] / b[..., 0]
    for i in range(1, n):
        m = b[..., i] - a[..., i] * cp[..., i - 1]
        cp[..., i] = c[..., i] / m
        dp[..., i] = (d[..., i] - a[..., i] * dp[..., i - 1]) / m
    u = np.zeros_like(d)
    u[..., -1] = dp[..., -1]
    for i in range(n - 2, -1, -1):
        u[..., i] = dp[..., i] - cp[..., i] * u[..., i + 1]
    return u


def _fgs_np(src, guide, lam, sigma, num_iters):
    """Float64 sequential-Thomas FGS — the quantitative reference for
    fgs_filter (same spec as cv::ximgproc's WLS internals, Min et al.
    2014; this environment's cv2 lacks ximgproc, so the parity anchor is
    this exact solver — VERDICT round 1 item 9)."""
    u = src.astype(np.float64)
    g = guide.astype(np.float64)
    denom = 4.0 ** num_iters - 1.0

    def pass_lastaxis(u, g, lam_t):
        # weights come from the (possibly lower-rank) guide; _thomas_np
        # broadcasts the (H, N) coefficients over any (B, H, N) RHS stack
        w = np.exp(-np.abs(g[..., 1:] - g[..., :-1]) / sigma)
        zero = np.zeros_like(w[..., :1])
        w_r = np.concatenate([w, zero], axis=-1)
        w_l = np.concatenate([zero, w], axis=-1)
        a = -lam_t * w_l
        c = -lam_t * w_r
        b = 1.0 + lam_t * (w_l + w_r)
        return _thomas_np(a, b, c, u)

    for t in range(num_iters):
        lam_t = 1.5 * lam * (4.0 ** (num_iters - t - 1)) / denom
        u = pass_lastaxis(u, g, lam_t)
        u = np.swapaxes(
            pass_lastaxis(np.swapaxes(u, -1, -2), np.swapaxes(g, -1, -2),
                          lam_t), -1, -2)
    return u


def test_fgs_parity_vs_exact_reference():
    """End-to-end FGS at the reference's λ=8000, σ=1.1 settings
    (stereo_disparity.cpp:11-13) vs the exact float64 sequential solver:
    MAE bound well under a 1/16-px disparity quantum."""
    rng = np.random.default_rng(7)
    H, W = 96, 144
    guide = np.cumsum(rng.normal(0, 8, (H, W)), axis=1).astype(np.float32)
    guide = np.clip(guide - guide.min(), 0, 255)
    src = (rng.random((H, W)) * 80).astype(np.float32)
    ours = np.asarray(fgs_filter(src, guide, lam=8000.0, sigma_color=1.1,
                                 num_iters=3))
    ref = _fgs_np(src, guide, 8000.0, 1.1, 3)
    mae = np.abs(ours - ref).mean()
    mx = np.abs(ours - ref).max()
    # disparity LSB is 1/16 px = 0.0625; the scan solver must sit far
    # below it
    assert mae < 5e-3, mae
    assert mx < 5e-2, mx


def test_wls_disparity_filter_parity_vs_exact_reference():
    """Full confidence-weighted WLS filter vs the float64 reference
    pipeline (same LR-consistency confidence + homogeneous division)."""
    rng = np.random.default_rng(8)
    H, W = 64, 96
    disp = 12.0 + 6.0 * np.sin(np.linspace(0, 6, W))[None, :] \
        + rng.normal(0, 0.2, (H, W))
    holes = rng.random((H, W)) < 0.25
    disp_l = np.where(holes, -1.0, disp).astype(np.float32)
    disp_r = disp.astype(np.float32)
    guide = np.clip(np.cumsum(rng.normal(0, 5, (H, W)), axis=1), -100,
                    100).astype(np.float32) + 100.0
    ours, conf = wls_disparity_filter(disp_l, disp_r, guide)
    ours = np.asarray(ours)
    conf = np.asarray(conf)

    num = _fgs_np(conf * np.maximum(disp_l, 0.0), guide, 8000.0, 1.1, 3)
    den = _fgs_np(conf, guide, 8000.0, 1.1, 3)
    ref = np.where(den > 1e-3, num / np.maximum(den, 1e-6), -1.0)
    ok = ref >= 0
    mae = np.abs(ours[ok] - ref[ok]).mean()
    # invalid masks agree (left columns x < disp have no right match)
    assert ((ours >= 0) == ok).mean() > 0.999
    assert mae < 1e-2, mae


def test_wls_inpaints_invalid_regions():
    rng = np.random.default_rng(2)
    H, W = 48, 64
    disp = np.full((H, W), 20.0, np.float32)
    disp += rng.normal(0, 0.3, (H, W)).astype(np.float32)
    holes = rng.random((H, W)) < 0.3
    disp_l = np.where(holes, -1.0, disp).astype(np.float32)
    disp_r = disp.astype(np.float32)      # consistent where valid
    guide = np.full((H, W), 128.0, np.float32)
    filt, conf = wls_disparity_filter(disp_l, disp_r, guide)
    filt = np.asarray(filt)
    assert (filt >= 0).mean() > 0.99
    assert np.abs(filt - 20.0).mean() < 0.5


@pytest.fixture(scope="module")
def wls_data():
    rng = np.random.default_rng(4)
    guide = rng.uniform(0, 255, (48, 96)).astype(np.float32)
    src = rng.uniform(0, 64, (2, 48, 96)).astype(np.float32)
    return src, guide


def test_fgs_stacked_rhs_vs_exact_reference(wls_data):
    """Two right-hand sides through one FGS solve (the numerator and
    denominator stack of wls_disparity_filter) vs the float64 solver."""
    src, guide = wls_data
    got = np.asarray(fgs_filter(src, guide))
    exact = _fgs_np(src, guide, 8000.0, 1.1, 3)
    rel = np.abs(got - exact).max() / max(1.0, np.abs(exact).max())
    assert rel < 5e-3, rel


@pytest.mark.parametrize("hole_frac", [0.2, 0.5])
def test_wls_random_pair_vs_exact_reference(wls_data, hole_frac):
    """Random left/right pair with holes on a noise guide: invalid masks
    and filtered values agree with the float64 reference pipeline."""
    _, guide = wls_data
    rng = np.random.default_rng(5)
    dl = rng.uniform(0, 32, guide.shape).astype(np.float32)
    dl[rng.uniform(size=dl.shape) < hole_frac] = -1.0
    dr = (dl + rng.normal(0, 0.3, dl.shape)).astype(np.float32)
    got, conf = wls_disparity_filter(dl, dr, guide)
    got, conf = np.asarray(got), np.asarray(conf)
    num = _fgs_np(conf * np.maximum(dl, 0.0), guide, 8000.0, 1.1, 3)
    den = _fgs_np(conf, guide, 8000.0, 1.1, 3)
    ref = np.where(den > 1e-3, num / np.maximum(den, 1e-6), -1.0)
    ok = ref >= 0
    assert ((got >= 0) == ok).mean() > 0.999
    assert np.abs(got[ok] - ref[ok]).mean() < 1e-2
