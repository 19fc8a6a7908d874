"""The parts of chip_smoke.py that need no card, on the CPU.

The card-vs-CPU phase compares the two with TF32 off; it must leave the
process's TF32 settings as it found them, since the phases after it time
the paths at PyTorch's defaults. Without a CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke  # noqa: E402


def _tf32():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def test_card_vs_cpu_phase_leaves_the_tf32_settings(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    rep = chip_smoke.Report("CPU")
    chip_smoke.phase_card_vs_cpu(torch, rep)        # touches no setting
    assert _tf32() == (True, True)
    with chip_smoke.full_f32(torch):
        assert _tf32() == (False, False)
        chip_smoke.phase_card_vs_cpu(torch, rep)
    assert _tf32() == (True, True)
    with pytest.raises(RuntimeError):
        with chip_smoke.full_f32(torch):
            chip_smoke.fail("a failing phase")
    assert _tf32() == (True, True)


def test_bounds_count_the_bytes_each_input_and_output_moves_once():
    ms, by, nbytes = chip_smoke.k4_bound(64, 56, 96, 256, 56)
    assert nbytes == 2 * 64 * 56 * 96 * 256 * 2 + 9 * 56 * 56 * 2 + 2 * 56 * 4
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e9)


def test_k3_bound_counts_only_what_the_crops_need():
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_params as wp
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_warp2

    frames, canvas, _, _, prm = exp_warp2.make_workload(
        np.random.default_rng(0), 1, 4, fh=320, fw=640, device="cpu")
    fp, cp = wp.planarize(frames), wp.planarize(canvas)
    bd = chip_smoke.k3_bound(fp, cp, prm)
    counts, hit_f, hit_c = exp_warp2.needed(fp, cp, prm)
    assert bd["src_px"] == int(hit_f.sum()) + int(hit_c.sum()) > 0
    assert bd["bytes"] == 4 * 3 * 112 * 112 * 4 + 4 * 64 + 3 * bd["src_px"]
    assert bd["positions"] == sum(counts) < 4 * (192 * 512 + 3 * 192 * 192
                                                + 112 * 112)
    t_bytes, t_ops = bd["bytes"] / 3.35e9, bd["flops"] / 67e9
    assert bd["ms"] == pytest.approx(max(t_bytes, t_ops))
    assert bd["by"] == ("bytes" if t_bytes >= t_ops else "operations")
    # the scratch: pass 1's (F, 3, 192, 512) and two (F, 3, 192, 192), f32
    assert bd["scratch"] == 4 * 3 * (192 * 512 + 2 * 192 * 192) * 4


def test_standin_expectation_is_said_and_zero_faces_fail():
    assert "NOT MET" in chip_smoke.standin_expectation(80, 80)
    assert "expectation met" in chip_smoke.standin_expectation(37, 80)
    with pytest.raises(RuntimeError):
        chip_smoke.standin_expectation(0, 80)


@pytest.mark.parametrize("alone", [False, True])
def test_smoke_exits_nonzero_without_a_card_or_the_repository(tmp_path,
                                                              alone):
    cwd = _REPO
    if alone:
        shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
