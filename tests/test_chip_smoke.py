"""chip_smoke.py without a GPU: it must exit non-zero and never print its
result line — neither from the repo nor alone in an empty directory."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_without_gpu_fails(capsys, argv):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.main(argv) != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_alone_in_a_directory_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_ground_truth_distance_is_metric():
    """The measure phase's ground truth: two points 50 px apart at
    disparity d on the synthetic rig are 50 * B / d mm apart."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    import numpy as np
    from stereo_depth_ruler_tpu.calib.config import StereoRig
    gt = np.full((chip_smoke.H, chip_smoke.W), 40.0, np.float32)
    p1, p2 = chip_smoke._gt_points(gt)
    assert p2[0] - p1[0] == 50 and p1[1] == p2[1]
    B = StereoRig.synthetic(width=chip_smoke.W, height=chip_smoke.H).baseline
    assert chip_smoke._gt_distance_cm(gt, p1, p2) == pytest.approx(
        50 * B / 40.0 / 10.0, rel=1e-9)
