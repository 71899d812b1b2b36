"""Command-line interface — real flags instead of the reference's
hard-coded paths (app/stereo_ruler.cpp:16-38, SURVEY.md §2.6).

Commands:
  run        video -> disparity/depth + metrics (+ measurement overlay
             export); the stereo_ruler main loop, headless
  measure    two-point distances on a chosen frame -> CSV session
  cloud      point-cloud export (the point_cloud binary)
  calibrate  chessboard stereo calibration -> stereo.yaml
  bench      per-device benchmark (delegates to bench.py)
  synth      generate a synthetic side-by-side test video

Usage: python -m stereo_depth_ruler_tpu.cli <command> [flags]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from .utils.cache import enable_compile_cache


def _load_rig(args):
    from .calib.config import StereoRig
    if args.calib:
        return StereoRig.from_yaml(args.calib)
    return StereoRig.synthetic(width=args.width, height=args.height)


def _sgbm_params(args):
    from .ops.sgbm import SGBMParams
    return SGBMParams(num_disparities=args.num_disp,
                      block_size=args.block_size,
                      num_paths=args.paths)


def cmd_run(args) -> int:
    from .io.video import FrameCursor, VideoSource, host_batches
    from .measure import depth_coverage
    from .metrics import MetricsLog, FrameMetrics, frame_metrics
    from .parallel.mesh import initialize_distributed
    from .pipeline import PipelineConfig, StereoPipeline
    from .viz import DepthVis, DisparityVis, overlay_heat

    enable_compile_cache()
    # multi-host runtime bootstrap (no-op single-process; SURVEY §2.10)
    initialize_distributed()
    rig = _load_rig(args)
    cfg = PipelineConfig(sgbm=_sgbm_params(args), downscale=args.downscale,
                         use_wls=not args.no_wls,
                         lr_mode="right_matcher" if not args.no_wls else "fast")
    pipe = StereoPipeline(rig, cfg, rectify=not args.no_rectify)
    src = VideoSource(args.video)
    log = MetricsLog(args.metrics) if args.metrics else MetricsLog()
    cursor = None
    if args.resume and Path(args.resume).exists():
        cursor = FrameCursor.load(args.resume)
        print(f"resuming at frame {cursor.next_frame}", file=sys.stderr)
    elif args.resume:
        cursor = FrameCursor(source=str(args.video))

    writer = None
    if args.overlay_out:
        from .io.video import SbsVideoWriter
        writer = SbsVideoWriter(args.overlay_out, fps=30.0)
        dvis = DisparityVis(cfg.sgbm.num_disparities)

    viewer = None
    if getattr(args, "show", False):
        # reference UX parity: overlay + depth windows with the
        # freeze-frame click ruler (stereo_displayer.cpp:121-250);
        # degrades headless with a warning
        from . import viewer as viewer_mod
        if viewer_mod.available():
            viewer = viewer_mod.InteractiveViewer(
                cfg.sgbm.num_disparities, csv_path=args.show_csv)
        else:
            print("--show: no display backend available; continuing "
                  "headless", file=sys.stderr)

    import time
    import jax
    n_done = 0
    if jax.process_count() > 1:
        # per-host video segments (SURVEY §2.10 'Host I/O sharding'):
        # each host decodes and processes only its own slice; metrics
        # and overlays are per-host files
        batches = host_batches(src, args.batch, cursor=cursor)
    else:
        batches = src.batches(args.batch, cursor=cursor)
    quit_requested = False
    t_first = time.perf_counter()

    def _pipelined(batches):
        """Software-pipelined dispatch: batch N+1 is decoded (host) and
        dispatched while batch N's device results are being forced —
        JAX dispatch is async, so decode, host postprocessing, and device
        compute overlap (SURVEY §2.10 sequence/pipeline parallel; the
        reference's loop is fully serial, stereo_displayer.cpp:145-198).
        """
        pending = None
        for idxs, lefts, rights in batches:
            t0 = time.perf_counter()
            out = pipe.process_batch(lefts, rights)     # async
            # snapshot cursor AT dispatch: the source iterator runs a
            # batch ahead, so saving its live value would skip frames
            # whose results were never consumed on a crash
            snap = cursor.next_frame if cursor is not None else None
            if pending is not None:
                yield pending
            pending = (idxs, out, t0, snap)
        if pending is not None:
            yield pending

    need_maps = writer is not None or viewer is not None
    for idxs, out, t0, cursor_snap in _pipelined(batches):
        if need_maps:
            disp = np.asarray(out["disparity"])
            z = np.asarray(out["xyz"])[..., 2, :, :]
        else:
            # in-forward device-side stats: ONE execute per batch and a
            # 12 B/frame fetch (the maps are not fetched when nothing
            # consumes them)
            stats = np.asarray(out["frame_stats"])
        wall = (time.perf_counter() - t0) * 1000 / len(idxs)
        for k, fi in enumerate(idxs):
            if fi < 0:
                continue
            if need_maps:
                log.append(frame_metrics(int(fi), disp[k], z[k],
                                         skip_cols=cfg.sgbm.num_disparities,
                                         wall_ms=wall))
            else:
                log.append(FrameMetrics(
                    frame_index=int(fi),
                    valid_disparity_frac=float(stats[k, 0]),
                    depth_coverage=float(stats[k, 1]),
                    mean_depth_mm=float(stats[k, 2]),
                    wall_ms=wall))
            if writer is not None:
                lrect = np.asarray(out["left_rectified"])[k]
                writer.write(overlay_heat(lrect, dvis(disp[k])))
            if viewer is not None:
                lrect = np.asarray(out["left_rectified"])[k]
                if not viewer.show_frame(
                        lrect, disp[k],
                        pipe.xyz_hwc(np.asarray(out["xyz"])[k])):
                    # ESC: fall through to the shared epilogue so the
                    # overlay mp4 is finalized and the resume cursor
                    # saved (frames up to and including this one count
                    # as done)
                    quit_requested = True
                    n_done += 1
                    break
            n_done += 1
            if args.max_frames and n_done >= args.max_frames:
                break
        if cursor is not None and args.resume:
            live = cursor.next_frame
            cursor.next_frame = cursor_snap
            cursor.save(args.resume)
            cursor.next_frame = live
        if quit_requested or (args.max_frames and n_done >= args.max_frames):
            break
    else:
        if cursor is not None and args.resume:
            # source exhausted and every batch consumed — record the
            # live (fully processed) position
            cursor.save(args.resume)
    if viewer is not None:
        viewer.close()
    if writer is not None:
        writer.close()
    summary = log.summary()
    elapsed = time.perf_counter() - t_first
    if n_done and elapsed > 0:
        # decode + dispatch + postprocess, wall-clock end to end — the
        # number the reference's live loop would show (SURVEY §2.10)
        summary["video_end_to_end_fps"] = round(n_done / elapsed, 3)
    print(json.dumps(summary))
    return 0


def cmd_measure(args) -> int:
    from .io.video import VideoSource
    from .measure import MeasurementSession
    from .pipeline import PipelineConfig, StereoPipeline

    enable_compile_cache()
    rig = _load_rig(args)
    cfg = PipelineConfig(sgbm=_sgbm_params(args), downscale=args.downscale,
                         use_wls=not args.no_wls)
    pipe = StereoPipeline(rig, cfg, rectify=not args.no_rectify)
    src = VideoSource(args.video)
    out = None
    for i, (left, right) in enumerate(src.frames(start=args.frame)):
        out = pipe.process_pair(left, right)
        break
    if out is None:
        print(f"no frame {args.frame} in {args.video}", file=sys.stderr)
        return 1
    xyz = pipe.xyz_hwc(out["xyz"])
    sess = MeasurementSession(args.csv)
    for pair in args.points:
        x1, y1, x2, y2 = (int(v) for v in pair.split(","))
        rec = sess.measure((x1, y1), (x2, y2), xyz)
        print(f"{rec.point1} -> {rec.point2}: {rec.distance_cm:.5f} cm")
    if args.csv:
        sess.save_csv()
    return 0


def cmd_cloud(args) -> int:
    from .cloud import CloudConfig, PointCloudGenerator
    from .io.video import VideoSource

    enable_compile_cache()
    rig = _load_rig(args)
    gen = PointCloudGenerator(rig, CloudConfig(
        sgbm=_sgbm_params(args), leaf=args.leaf))
    src = VideoSource(args.video)
    frames = [args.frame] if args.frame is not None else None
    count = 0
    for i, (left, right) in enumerate(src.frames(
            start=args.frame or 0)):
        path = gen.write_frame(args.out, (args.frame or 0) + count,
                               left, right)
        print(f"wrote {path}", file=sys.stderr)
        count += 1
        if args.frame is not None or (args.max_frames
                                      and count >= args.max_frames):
            break
    return 0


def cmd_calibrate(args) -> int:
    from .calib.calibrate import CalibrationSettings, StereoCalibrator
    s = CalibrationSettings(board_cols=args.board_cols,
                            board_rows=args.board_rows,
                            square_size_mm=args.square_mm)
    cal = StereoCalibrator(s)
    rig = cal.calibrate_dirs(args.left_dir, args.right_dir, args.out)
    cal.print_results()
    print(f"saved {args.out}")
    return 0


def cmd_synth(args) -> int:
    from .calib.config import StereoRig
    from .io.synthetic import make_scene, make_sbs_video_frames
    from .io.video import write_sbsv

    rig = StereoRig.synthetic(width=args.width, height=args.height)
    scene = make_scene(rig, n_boxes=args.boxes, seed=args.seed)
    frames, gt = make_sbs_video_frames(scene, args.frames, seed=args.seed)
    write_sbsv(args.out, frames)
    if args.gt_out:
        np.save(args.gt_out, gt)
    print(f"wrote {args.out} ({args.frames} frames "
          f"{frames.shape[1]}x{frames.shape[2]})")
    return 0


def cmd_bench(args) -> int:
    import subprocess
    cmd = [sys.executable, str(Path(__file__).resolve().parent.parent
                               / "bench.py")]
    if args.no_full:
        cmd.append("--no-full")
    if args.sweep:
        cmd.append("--sweep")
    if args.iters:
        cmd += ["--iters", str(args.iters)]
    return subprocess.call(cmd)


def _common(p, video=True):
    p.add_argument("--calib", help="stereo.yaml calibration file")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--num-disp", type=int, default=128)
    p.add_argument("--block-size", type=int, default=5)
    p.add_argument("--paths", type=int, default=8, choices=[2, 4, 8])
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--no-wls", action="store_true")
    p.add_argument("--no-rectify", action="store_true")
    if video:
        p.add_argument("video", help="side-by-side video (.mp4/.sbsv/.npy)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sdr", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="process a video")
    _common(p)
    # the largest full-pipeline batch that fits one 80 GB H100 at
    # 1280x720x128 (PERF.md); smaller frames or a CPU may want less
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--max-frames", type=int)
    p.add_argument("--metrics", help="metrics JSONL path")
    p.add_argument("--overlay-out", help="overlay mp4 path")
    p.add_argument("--resume", help="cursor JSON for checkpoint/resume")
    p.add_argument("--show", action="store_true",
                   help="local OpenCV viewer: overlay + depth windows, "
                        "'f' freezes for click-to-measure (needs display)")
    p.add_argument("--show-csv", help="CSV path for --show measurements")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("measure", help="two-point measurement")
    _common(p)
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--points", nargs="+", required=True,
                   metavar="x1,y1,x2,y2")
    p.add_argument("--csv")
    p.set_defaults(fn=cmd_measure)

    p = sub.add_parser("cloud", help="point-cloud export")
    _common(p)
    p.add_argument("--out", default="results")
    p.add_argument("--frame", type=int)
    p.add_argument("--max-frames", type=int)
    p.add_argument("--leaf", type=float, default=5.0)
    p.set_defaults(fn=cmd_cloud)

    p = sub.add_parser("calibrate", help="chessboard calibration")
    p.add_argument("left_dir")
    p.add_argument("right_dir")
    p.add_argument("--out", default="stereo.yaml")
    p.add_argument("--board-cols", type=int, default=8)
    p.add_argument("--board-rows", type=int, default=6)
    p.add_argument("--square-mm", type=float, default=19.0)
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("synth", help="synthetic stereo video")
    p.add_argument("--out", default="synth.sbsv")
    p.add_argument("--gt-out")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--boxes", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("bench", help="per-device benchmark")
    p.add_argument("--no-full", action="store_true",
                   help="skip the full-pipeline benchmark")
    p.add_argument("--sweep", action="store_true",
                   help="also run the 2560x1440x256 stress config")
    p.add_argument("--iters", type=int, default=0,
                   help="timed batches per window (bench.py default)")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
