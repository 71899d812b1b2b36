"""Benchmark: stereo frames/s on one GPU at 1280x720 x 128-disparity SGBM,
beside the OpenCV-CPU baseline (BASELINE.json primary metric).

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": "frames/s", "device": {...}, ...}
Details go to stderr. Needs a GPU (it fails without one) and should be the
only process on the card: a JAX process reserves most of its memory.

Timing: after a warm-up call that compiles (reported as set-up time), a
steady window of back-to-back batches that ends in `block_until_ready`.
"""

import argparse
import json
import sys
import time

import numpy as np

H, W, D = 720, 1280, 128
# frames per device call: the largest batch whose full-pipeline step fits
# the memory a JAX process reserves on an 80 GB H100 (PERF.md)
BATCH = 16


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_inputs(batch=BATCH):
    from stereo_depth_ruler_tpu.calib.config import StereoRig
    from stereo_depth_ruler_tpu.io.synthetic import (make_scene,
                                                     render_stereo_pair)
    rig = StereoRig.synthetic(width=W, height=H)
    scene = make_scene(rig, n_boxes=5, z_range_mm=(900.0, 4000.0),
                       background_z_mm=6000.0, seed=0)
    lefts, rights = [], []
    for i in range(batch):
        l, r, _ = render_stereo_pair(scene, seed=0, shift=(2.0 * i, 0.0))
        lefts.append(l)
        rights.append(r)
    return rig, np.stack(lefts), np.stack(rights)


def bench_opencv(lefts, rights, frames=30, trials=5):
    """Reference-parameter cv2.StereoSGBM at the headline config
    (numDisparities=128; other params as stereo_disparity.cpp:5-9), on the
    host CPU: >=30 frames per trial, median of >=5 trials, spread logged.
    Returns (fps, None), or (None, reason) where cv2 is not installed."""
    try:
        import cv2
    except ImportError as e:
        return None, f"cv2 not installed: {e}"
    matcher = cv2.StereoSGBM_create(
        minDisparity=0, numDisparities=D, blockSize=5,
        P1=8 * 3 * 25, P2=32 * 3 * 25, disp12MaxDiff=1, preFilterCap=63,
        uniquenessRatio=12, speckleWindowSize=200, speckleRange=2,
        mode=cv2.STEREO_SGBM_MODE_SGBM_3WAY)
    matcher.compute(lefts[0], rights[0])  # warm
    fps = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for n in range(frames):
            matcher.compute(lefts[n % len(lefts)], rights[n % len(rights)])
        fps.append(frames / (time.perf_counter() - t0))
    fps.sort()
    med = fps[len(fps) // 2]
    log(f"OpenCV trials fps: {['%.2f' % f for f in fps]} "
        f"median {med:.2f} spread {(fps[-1] - fps[0]) / med * 100:.0f}%")
    return med, None


COMPILE_S = {}


def _steady_fps(name, fn, args, frames_per_call, iters):
    """Compile + first call (set-up), then `iters` back-to-back calls
    ending in block_until_ready. Returns frames/s of the window."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    COMPILE_S[name] = time.perf_counter() - t0
    log(f"{name}: compile + first call {COMPILE_S[name]:.1f} s")
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    jax.block_until_ready(outs)
    return iters * frames_per_call / (time.perf_counter() - t0)


def bench_matcher(rig, lefts, rights, iters=8):
    """Left matcher + LR + speckle + Q-reprojection, vmapped over the
    batch, with the platform's aggregator (ops/backend.py)."""
    import jax
    import jax.numpy as jnp

    from stereo_depth_ruler_tpu.ops.backend import select_aggregator
    from stereo_depth_ruler_tpu.ops.reproject import reproject_to_3d
    from stereo_depth_ruler_tpu.ops.sgbm import SGBMParams, sgbm

    params = SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=200, speckle_range=2)
    agg = select_aggregator()

    def one(left, right):
        disp = sgbm(left, right, params, aggregator=agg)
        return disp, reproject_to_3d(disp, rig.Q)[..., 2]

    fwd = jax.jit(jax.vmap(one))
    lb = jnp.asarray(lefts, jnp.float32)
    rb = jnp.asarray(rights, jnp.float32)
    fps = _steady_fps("matcher", fwd, (lb, rb), lb.shape[0], iters)
    disp = np.asarray(fwd(lb, rb)[0][0])
    log(f"valid disparity frac: {(disp >= 0).mean():.3f}")
    return fps


def bench_full_pipeline(rig, lefts, rights, iters=6):
    """The reference's complete live path: rectify -> SGBM x2 (left +
    ximgproc-style right matcher) -> WLS -> reproject
    (stereo_disparity.cpp:17-39) at the full-res headline config."""
    import jax.numpy as jnp

    from stereo_depth_ruler_tpu.ops.sgbm import SGBMParams
    from stereo_depth_ruler_tpu.pipeline import PipelineConfig, StereoPipeline

    params = SGBMParams(num_disparities=D, block_size=5,
                        speckle_window_size=200, speckle_range=2)
    cfg = PipelineConfig(sgbm=params, downscale=1, use_wls=True,
                         lr_mode="right_matcher")
    pipe = StereoPipeline(rig, cfg, rectify=True)
    lb = jnp.asarray(lefts, jnp.float32)
    rb = jnp.asarray(rights, jnp.float32)
    return _steady_fps("full_pipeline", pipe._forward_batch, (lb, rb),
                       lb.shape[0], iters)


def bench_sweep(iters=3):
    """The 2560x1440x256 stress config: one frame per call."""
    import jax
    import jax.numpy as jnp

    from stereo_depth_ruler_tpu.ops.backend import select_aggregator
    from stereo_depth_ruler_tpu.ops.sgbm import SGBMParams, sgbm

    Hs, Ws, Ds = 1440, 2560, 256
    params = SGBMParams(num_disparities=Ds, block_size=5,
                        speckle_window_size=200, speckle_range=2)
    rng = np.random.default_rng(0)
    left = rng.uniform(0, 255, (Hs, Ws)).astype(np.float32)
    right = jnp.asarray(np.roll(left, -20, axis=1))
    agg = select_aggregator()
    fwd = jax.jit(lambda a, b: sgbm(a, b, params, aggregator=agg))
    return _steady_fps("sweep", fwd, (jnp.asarray(left), right), 1, iters)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-full", action="store_true")
    ap.add_argument("--sweep", action="store_true",
                    help="also run the 2560x1440x256 stress config")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--cv-frames", type=int, default=30)
    args = ap.parse_args()

    from stereo_depth_ruler_tpu.utils.cache import enable_compile_cache
    from stereo_depth_ruler_tpu.utils.device import (device_record,
                                                     nvidia_smi_name_power)
    device = device_record()
    if device["platform"] != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {device}")
    enable_compile_cache()
    card = nvidia_smi_name_power()
    log(f"card (name, power limit): {card}")

    rig, lefts, rights = make_inputs()
    log("benchmarking OpenCV CPU baseline...")
    cv_fps, cv_reason = bench_opencv(lefts, rights, frames=args.cv_frames)
    log(f"OpenCV CPU SGBM_3WAY {W}x{H}x{D}: {cv_fps or cv_reason}")

    fps = bench_matcher(rig, lefts, rights, iters=args.iters)
    log(f"matcher {W}x{H}x{D} batch {BATCH}: {fps:.2f} fps")

    extra = {}
    if not args.no_full:
        full_fps = bench_full_pipeline(rig, lefts, rights,
                                       iters=max(2, args.iters // 2))
        log(f"full pipeline {W}x{H}x{D} batch {BATCH}: {full_fps:.2f} fps")
        extra["full_pipeline_fps"] = full_fps
    if args.sweep:
        sweep_fps = bench_sweep()
        log(f"sweep 2560x1440x256: {sweep_fps:.2f} fps")
        extra["sweep_2560x1440x256_fps"] = sweep_fps

    print(json.dumps({
        "metric": f"stereo_fps_{W}x{H}_{D}disp_sgbm",
        "value": fps,
        "unit": "frames/s",
        "batch": BATCH,
        "device": device,
        "card": card,
        "cv_baseline_fps": cv_fps,
        "cv_baseline_note": cv_reason,
        "vs_cv_baseline": fps / cv_fps if cv_fps else None,
        "compile_s": COMPILE_S,
        **extra,
    }))


if __name__ == "__main__":
    main()
