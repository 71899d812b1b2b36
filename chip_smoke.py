"""Smoke test of the stereo engine on one NVIDIA GPU, through the entry
points a user calls, at the headline deployment: a 1280x720 rig, 128
disparities, 8-path SGBM, the left and right matchers, WLS and
Q-reprojection.

    python chip_smoke.py                # one card: phases 1-5
    python chip_smoke.py --four-cards   # four cards: phase 6 only

Phases (one line each before the last):
 1. device    the card's name and power limit (nvidia-smi) and jax.devices()
 5. footprint cold compile time, memory analysis and peak device memory of
              the batched full-pipeline step (run first, so it compiles cold)
 2. main path `synth` -> `run` (batch 4, WLS) -> `measure` -> `cloud`, the CLI
              called in-process
 3. kernel    the GPU SGM traversal vs jnp `aggregate_paths` on the card,
              bitwise, at 1280x720x128 and 2560x1440x256
 4. parity    each pipeline stage on the card vs the same jnp stage on the
              host CPU backend, on one 720p frame
 6. 4 cards   `pipeline_step_sharded` on a (frame=2, tile=2, disp=1) mesh vs
              single-card `StereoPipeline` (halo=64), and an exact=True
              `sgbm_sharded` run that must equal single-card `sgbm` bitwise

The last line of stdout is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU the script exits non-zero and prints no result. Any failing
check raises, so a failed phase exits non-zero. Everything runs in this
one process: a JAX process reserves most of the card's memory.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import sys
import time
from pathlib import Path

import numpy as np

H, W, D = 720, 1280, 128
KERNEL_SHAPES = ((H, W, D), (1440, 2560, 256))
ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"


def say(phase: str, text: str) -> None:
    print(f"[{phase}] {text}", flush=True)


def _cli(argv) -> str:
    """Run the CLI in this process; returns what it printed to stdout."""
    from stereo_depth_ruler_tpu import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"cli {argv[0]} exited {rc}")
    return buf.getvalue()


def _headline_pipeline(**config):
    """The StereoPipeline `cli run` builds for the flags used below."""
    from stereo_depth_ruler_tpu.calib.config import StereoRig
    from stereo_depth_ruler_tpu.ops.sgbm import SGBMParams
    from stereo_depth_ruler_tpu.pipeline import PipelineConfig, StereoPipeline
    cfg = PipelineConfig(sgbm=SGBMParams(num_disparities=D), downscale=1,
                         **config)
    return StereoPipeline(StereoRig.synthetic(width=W, height=H), cfg)


def _frames(n, seed=0):
    """n synthetic 720p frame pairs, uint8 like the video reader's."""
    from stereo_depth_ruler_tpu.calib.config import StereoRig
    from stereo_depth_ruler_tpu.io.synthetic import (make_sbs_video_frames,
                                                     make_scene)
    scene = make_scene(StereoRig.synthetic(width=W, height=H), n_boxes=4,
                       seed=seed)
    frames, gt = make_sbs_video_frames(scene, n, seed=seed)
    return frames[:, :, :W], frames[:, :, W:], gt


def phase_device():
    import jax
    from stereo_depth_ruler_tpu.utils.device import nvidia_smi_name_power
    say("device", f"nvidia-smi: {nvidia_smi_name_power()}")
    say("device", f"jax.devices(): {jax.devices()}")


def phase_footprint(batch=4):
    import jax
    pipe = _headline_pipeline()
    lefts, rights, _ = _frames(batch)
    t0 = time.perf_counter()
    compiled = pipe._forward_batch.lower(lefts, rights).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(lefts, rights))
    ma = compiled.memory_analysis()
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    say("footprint", f"batch {batch} full pipeline: compile {compile_s:.1f} s, "
        f"temp {ma.temp_size_in_bytes} B, args {ma.argument_size_in_bytes} B, "
        f"out {ma.output_size_in_bytes} B, peak_bytes_in_use {peak}")


def _gt_points(gt):
    """Two pixels 50 px apart on one flat surface of the ground truth,
    right of the unreliable left band, away from depth edges."""
    best = None
    for y in range(H // 4, 3 * H // 4, 8):
        for x in range(D + 60, W - 60, 8):
            win = gt[y - 4:y + 5, x - 30:x + 31]
            if np.ptp(win) == 0 and (best is None or gt[y, x] > best[0]):
                best = (gt[y, x], x, y)
    if best is None:
        raise RuntimeError("no flat ground-truth region to measure on")
    _, x, y = best
    return (x - 25, y), (x + 25, y)


def _gt_distance_cm(gt, p1, p2):
    from stereo_depth_ruler_tpu.calib.config import StereoRig
    Q = StereoRig.synthetic(width=W, height=H).Q
    pts = []
    for x, y in (p1, p2):
        X = Q @ np.array([x, y, gt[y, x], 1.0])
        pts.append(X[:3] / X[3])
    return float(np.linalg.norm(pts[0] - pts[1])) / 10.0


def phase_main_path():
    from stereo_depth_ruler_tpu.io.pcd import read_pcd
    from stereo_depth_ruler_tpu.io.video import VideoSource
    WORK.mkdir(parents=True, exist_ok=True)
    video, gt_path = WORK / "synth.sbsv", WORK / "gt.npy"
    common = ["--num-disp", D, "--downscale", 1, "--width", W,
              "--height", H]

    _cli(["synth", "--out", video, "--gt-out", gt_path, "--frames", 16,
          "--width", W, "--height", H, "--seed", 0])
    src = VideoSource(video)
    reader = ("numpy read_sbsv (io/video.py)" if src._frames is not None
              else "OpenCV VideoCapture")
    say("main", f"synth: {len(src)} frames {W}x{H}, reader: {reader}")

    t0 = time.perf_counter()
    summary = json.loads(_cli(["run", video, "--batch", 4, *common])
                         .strip().splitlines()[-1])
    say("main", f"run ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(summary)}")
    if summary["frames"] != 16 or not summary["valid_disparity_frac"] > 0.9:
        raise RuntimeError(f"run summary out of bounds: {summary}")

    gt = np.load(gt_path)[0]
    p1, p2 = _gt_points(gt)
    out = _cli(["measure", video, "--frame", 0, *common, "--points",
                f"{p1[0]},{p1[1]},{p2[0]},{p2[1]}"])
    got = float(re.search(r":\s*([0-9.]+) cm", out).group(1))
    want = _gt_distance_cm(gt, p1, p2)
    say("main", f"measure {p1}->{p2}: {got:.5f} cm, ground truth "
        f"{want:.5f} cm, rel err {abs(got - want) / want:.5f}")
    if not abs(got - want) <= 0.03 * want:
        raise RuntimeError("measured distance off by more than 3%")

    _cli(["cloud", video, "--frame", 0, "--out", WORK / "cloud", *common])
    xyz, rgb, _ = read_pcd(WORK / "cloud" / "frame_00000.pcd")
    say("main", f"cloud: {len(xyz)} points written")
    if len(xyz) < 1000 or not np.isfinite(xyz).all():
        raise RuntimeError(f"cloud has {len(xyz)} points")


def _cost_volume(h, w, d, seed=0):
    import jax
    import jax.numpy as jnp
    from stereo_depth_ruler_tpu.ops.sgbm import (box_filter_volume,
                                                 bt_cost_volume, sobel_clip)
    rng = np.random.default_rng(seed)
    left = jnp.asarray(rng.uniform(0, 255, (h, w)).astype(np.float32))
    right = jnp.roll(left, -9, axis=1)
    return jax.jit(lambda l, r: box_filter_volume(bt_cost_volume(
        sobel_clip(l, 63), sobel_clip(r, 63), d), 5))(left, right)


def phase_kernel():
    import jax
    import jax.numpy as jnp
    from stereo_depth_ruler_tpu.ops.sgbm import SGBMParams, aggregate_paths
    from stereo_depth_ruler_tpu.ops.sgm_gpu import aggregate_paths_gpu
    for h, w, d in KERNEL_SHAPES:
        p = SGBMParams(num_disparities=d)
        C = _cost_volume(h, w, d)
        same = jax.jit(lambda c: jnp.array_equal(
            aggregate_paths_gpu(c, p.P1, p.P2, 8),
            aggregate_paths(c, p.P1, p.P2, 8)))(C)
        say("kernel", f"GPU traversal vs jnp aggregate_paths at {w}x{h}x{d}, "
            f"8 paths: bitwise equal = {bool(same)}")
        if not bool(same):
            raise RuntimeError("GPU traversal differs from aggregate_paths")
        del C


def phase_parity():
    """Each stage on the card vs the same jnp stage on the host CPU, on
    identical inputs. The path has no matrix product on the device
    (reprojection is elementwise), so TF32 cannot enter; the CPU
    reference still runs at the highest matmul precision."""
    import jax
    import jax.numpy as jnp
    from stereo_depth_ruler_tpu.calib.config import StereoRig
    from stereo_depth_ruler_tpu.ops.backend import select_aggregator
    from stereo_depth_ruler_tpu.ops.remap import (build_remap_grids,
                                                  remap_bilinear)
    from stereo_depth_ruler_tpu.ops.reproject import reproject_to_3d
    from stereo_depth_ruler_tpu.ops.sgbm import SGBMParams, sgbm
    from stereo_depth_ruler_tpu.ops.wls import wls_disparity_filter

    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    params = SGBMParams(num_disparities=D)
    rig = StereoRig.synthetic(width=W, height=H)
    lefts, rights, _ = _frames(1, seed=3)

    def stages(aggregator):
        grid_l, grid_r = build_remap_grids(rig)   # on the default device

        def run(left, right):
            lr = remap_bilinear(left.astype(jnp.float32), grid_l,
                                precision="u8")
            rr = remap_bilinear(right.astype(jnp.float32), grid_r,
                                precision="u8")
            pair_l = jnp.stack([lr, rr[:, ::-1]])
            pair_r = jnp.stack([rr, lr[:, ::-1]])
            dd = jax.vmap(lambda a, b: sgbm(a, b, params,
                                            aggregator=aggregator))(
                pair_l, pair_r)
            return lr, rr, dd[0], dd[1][:, ::-1]
        return jax.jit(run)

    wls = jax.jit(lambda dl, dr, guide: wls_disparity_filter(dl, dr,
                                                             guide)[0])
    xyz = jax.jit(lambda disp: reproject_to_3d(disp, rig.Q))

    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        ref = stages(select_aggregator("cpu"))(lefts[0], rights[0])
        ref = [np.asarray(a) for a in ref]
        ref_wls = np.asarray(wls(ref[2], ref[3], ref[0]))
        ref_xyz = np.asarray(xyz(ref_wls))
    got = [np.asarray(a) for a in stages(select_aggregator())(
        jax.device_put(lefts[0], gpu), jax.device_put(rights[0], gpu))]
    # WLS and reprojection on the card, each from the CPU stage's input
    got_wls = np.asarray(wls(*(jax.device_put(a, gpu)
                               for a in (ref[2], ref[3], ref[0]))))
    got_xyz = np.asarray(xyz(jax.device_put(ref_wls, gpu)))

    for k, name in ((2, "left"), (3, "right")):
        same = (got[k] == ref[k]).mean()
        mx = np.abs(got[k] - ref[k]).max()
        say("parity", f"SGM {name} disparity: identical on {same:.6f} of "
            f"pixels, max |diff| {mx} px")
        if not (same >= 0.9999 and mx <= 1 / 16):
            raise RuntimeError(f"SGM {name} disparity out of tolerance")
    # the FGS systems (I + lam*A) have a condition number of about
    # 2*lam, so two float32 evaluations that round differently (exp,
    # fused multiply-adds) agree only to about 2 * lam * eps_f32
    wls_rtol = 2 * 8000.0 * float(np.finfo(np.float32).eps)
    g, r = got_wls, ref_wls
    both = (g >= 0) & (r >= 0)
    mask_same = ((g >= 0) == (r >= 0)).mean()
    rel = np.abs(g[both] - r[both]) / np.maximum(np.abs(r[both]), 1e-6)
    say("parity", f"WLS: valid masks agree on {mask_same:.6f}, rel diff max "
        f"{rel.max():.3e}, 99.99th pct {np.percentile(rel, 99.99):.3e}, "
        f"max |diff| {np.abs(g[both] - r[both]).max():.3e} px "
        f"(rtol {wls_rtol:.2e} = 2 * lam * eps_f32)")
    if not (mask_same >= 0.9999 and rel.max() <= wls_rtol):
        raise RuntimeError("WLS out of tolerance")
    g, r = got_xyz, ref_xyz
    fin = np.isfinite(r)
    rel = (np.abs(g[fin] - r[fin]) / np.maximum(np.abs(r[fin]), 1e-6)).max()
    say("parity", f"xyz: finite masks equal {bool((np.isfinite(g) == fin).all())}"
        f", max rel diff {rel:.3e} (tol 1e-5)")
    if not ((np.isfinite(g) == fin).all() and rel <= 1e-5):
        raise RuntimeError("xyz out of tolerance")


def phase_four_cards(h=H, w=W, d=D, halo=64):
    """The sharded pipeline over four devices vs one device."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from stereo_depth_ruler_tpu.calib.config import StereoRig
    from stereo_depth_ruler_tpu.io.synthetic import (make_sbs_video_frames,
                                                     make_scene)
    from stereo_depth_ruler_tpu.ops.backend import select_aggregator
    from stereo_depth_ruler_tpu.ops.remap import build_remap_grids
    from stereo_depth_ruler_tpu.ops.sgbm import SGBMParams, sgbm
    from stereo_depth_ruler_tpu.parallel.mesh import FRAME_AXIS, make_mesh
    from stereo_depth_ruler_tpu.parallel.sharded import (
        pipeline_step_sharded, sgbm_sharded)
    from stereo_depth_ruler_tpu.pipeline import PipelineConfig, StereoPipeline

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devs)}")
    devs = devs[:4]
    rig = StereoRig.synthetic(width=w, height=h)
    frames, _ = make_sbs_video_frames(make_scene(rig, n_boxes=4, seed=1), 4,
                                      seed=1)
    lefts = frames[:, :, :w].astype(np.float32)
    rights = frames[:, :, w:].astype(np.float32)
    # speckle off: the single-card matcher filters speckles per matcher,
    # the sharded step after WLS
    params = SGBMParams(num_disparities=d, speckle_window_size=0)

    mesh = make_mesh(frame=2, tile=2, disp=1, devices=devs)
    spec = NamedSharding(mesh, P(FRAME_AXIS))
    ls, rs = jax.device_put(lefts, spec), jax.device_put(rights, spec)
    placed = {dv.id for a in (ls, rs) for dv in a.sharding.device_set}
    t0 = time.perf_counter()
    out = pipeline_step_sharded(ls, rs, rig.Q, params, mesh, halo=halo,
                                rects=build_remap_grids(rig), use_wls=True)
    sharded = np.asarray(out["disparity"])
    out_devs = {dv.id for dv in out["disparity"].sharding.device_set}
    say("4cards", f"pipeline_step_sharded mesh (frame=2, tile=2, disp=1), "
        f"{w}x{h}x{d}, 4 frames, WLS, halo={halo}: "
        f"{time.perf_counter() - t0:.1f} s incl. compile; inputs on devices "
        f"{sorted(placed)}, output on {sorted(out_devs)}")
    if len(placed) != 4 or len(out_devs) != 4:
        raise RuntimeError("sharded step did not use all four devices")

    with jax.default_device(devs[0]):
        pipe = StereoPipeline(rig, PipelineConfig(
            sgbm=params, downscale=1, remap_precision="f32"))
        single = np.asarray(pipe.process_batch(lefts, rights)["disparity"])
    both = (sharded >= 0) & (single >= 0)
    diff = np.abs(sharded[both] - single[both])
    mask_same = ((sharded >= 0) == (single >= 0)).mean()
    within = (diff <= 1 / 16).mean()
    say("4cards", f"halo={halo} vs single-card StereoPipeline: valid masks "
        f"agree on {mask_same:.6f}, |diff| <= 1/16 px on {within:.6f}, "
        f"identical on {(diff == 0).mean():.6f}, max |diff| {diff.max():.4g}")
    if not (mask_same >= 0.999 and within >= 0.999):
        raise RuntimeError("halo-mode sharded output disagrees")

    exact_params = SGBMParams(num_disparities=d)
    emesh = make_mesh(tile=2, disp=2, devices=devs)
    t0 = time.perf_counter()
    ex = np.asarray(sgbm_sharded(lefts[0], rights[0], exact_params, emesh,
                                 exact=True))
    with jax.default_device(devs[0]):
        ref = np.asarray(jax.jit(lambda a, b: sgbm(
            a, b, exact_params, aggregator=select_aggregator()))(
                lefts[0], rights[0]))
    same = bool(np.array_equal(ex, ref))
    say("4cards", f"exact=True sgbm_sharded mesh (tile=2, disp=2) vs "
        f"single-card sgbm: bitwise equal = {same} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    if not same:
        raise RuntimeError("exact sharded matcher differs from single card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {jax.devices()[0].platform!r})",
              file=sys.stderr)
        return 1
    from stereo_depth_ruler_tpu.utils.cache import enable_compile_cache
    from stereo_depth_ruler_tpu.utils.device import device_record
    say("cache", f"compile cache: {enable_compile_cache()}")

    phase_device()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_footprint()
        phase_main_path()
        phase_kernel()
        phase_parity()
    print(json.dumps({"ok": True, "device": device_record()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
