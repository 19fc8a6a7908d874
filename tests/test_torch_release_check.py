"""The port's release gate (``tools/release_check.py``) and its multi-slot
dry run (``tools/dryrun_multichip.py``), on the CPU.

The dry run takes JAX's ``dryrun_multichip`` shapes and assertions on 8
CPU slots. The gate runs its steps in subprocesses, writes its report
where it is told, skips only what ``--skip`` names, and exits 1 when a
step that ran failed.
"""
import os

import pytest
import torch

from scrfd_arcface_facerecognition_tpu_torch.tools import (
    dryrun_multichip as dm, release_check as rc)
from torch_cores import shared_cores  # noqa: F401

pytestmark = pytest.mark.usefixtures("shared_cores")


def test_dryrun_multichip_on_8_cpu_slots(capsys):
    out = dm.dryrun_multichip(8, device="cpu")
    for key in ("loss", "pfc_loss", "det_loss"):
        assert out[key] == out[key] and abs(out[key]) < float("inf")
    said = capsys.readouterr().out
    assert "dryrun_multichip(8) on cpu" in said
    assert "mesh {'data': 2, 'model': 4} + {'model': 8}" in said


def test_the_gates_steps_are_the_ports():
    args = rc.parse_args(["--device", "cpu", "--log-dir", "/x"])
    steps = {name: cmd for name, cmd, _ in rc.step_commands(args)}
    assert list(steps) == ["tests", "multichip", "signoff", "mutate",
                           "uilint"]
    tests = steps["tests"]
    assert tests[1:3] == ["-m", "pytest"] and "not slow" in tests
    files = [a for a in tests if a.startswith("tests")]
    assert files and all(os.path.basename(f).startswith("test_torch_")
                         for f in files)
    assert "tests/test_torch_release_check.py" in files
    for name in ("multichip", "signoff", "mutate", "uilint"):
        assert steps[name][1:3] == ["-m", rc.TOOLS + {
            "multichip": "dryrun_multichip", "signoff": "verify_release",
            "mutate": "verify_release", "uilint": "check_ui_js"}[name]]
    assert steps["multichip"][-4:] == ["--slots", "8", "--device", "cpu"]
    assert "--mutate" in steps["mutate"] and "--mutate" not in steps[
        "signoff"]
    assert steps["signoff"][-1] == os.path.join("/x", "PARITY_gate.md")


def test_release_check_runs_uilint_and_writes_its_report(tmp_path, capsys):
    out = tmp_path / "gate.md"
    code = rc.main(["--device", "cpu", "--skip", "tests", "multichip",
                    "signoff", "mutate", "--log-dir", str(tmp_path),
                    "--out", str(out)])
    assert code == 0
    text = out.read_text()
    assert "| uilint | PASS |" in text and "**Overall: PASS**" in text
    for name in ("tests", "multichip", "signoff", "mutate"):
        assert f"| {name} | SKIP |" in text
    assert "ui script ok" in (tmp_path / "release_check_uilint.log"
                              ).read_text()
    assert "[gate] tests: SKIPPED" in capsys.readouterr().out


def test_release_check_fails_when_a_step_fails(tmp_path, monkeypatch):
    """A page whose script does not balance fails the uilint step: the
    gate exits 1 and its report says FAIL."""
    from scrfd_arcface_facerecognition_tpu_torch.apps.webui import (
        INDEX_HTML)

    head, script = INDEX_HTML.split("<script>", 1)
    page = tmp_path / "broken.html"
    page.write_text(head + "<script>" + script.replace("{", "", 1))
    real = rc.step_commands

    def with_broken_page(args):
        return [(name, cmd + [str(page)] if name == "uilint" else cmd, t)
                for name, cmd, t in real(args)]

    monkeypatch.setattr(rc, "step_commands", with_broken_page)
    out = tmp_path / "gate.md"
    code = rc.main(["--device", "cpu", "--skip", "tests", "multichip",
                    "signoff", "mutate", "--log-dir", str(tmp_path),
                    "--out", str(out)])
    assert code == 1
    text = out.read_text()
    assert "| uilint | FAIL |" in text and "**Overall: FAIL**" in text
    assert "unmatched" in (tmp_path / "release_check_uilint.log"
                            ).read_text()


def test_no_step_runs_without_a_card_unless_asked_for_the_cpu():
    """The gate's default device is the card, and the tools it calls
    refuse to fall back to the CPU."""
    assert rc.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dm.dryrun_multichip(2)
