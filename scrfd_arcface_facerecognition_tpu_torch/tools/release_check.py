"""One-command release gate of the port: every step, one verdict.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.release_check \
        [--device cpu] [--weights ./weights] [--skip tests ...] [--out F]

The port's counterpart of the JAX repository's ``tools/release_check.py``.
Each step runs in a fresh subprocess from the repository root, its output
in ``<log dir>/release_check_<step>.log``:

1. ``tests``: the port's CPU parity tests, ``python -m pytest
   tests/test_torch_*.py -q -m 'not slow'``. They need JAX for their
   references, so on a machine without it skip them with ``--skip tests``;
   nothing is skipped silently;
2. ``multichip``: ``tools.dryrun_multichip`` on 8 slots of ``--device``;
3. ``signoff``: ``tools.verify_release`` (the five-graph sign-off);
4. ``mutate``: ``tools.verify_release --mutate`` (the architecture read
   from the graph);
5. ``uilint``: ``tools.check_ui_js`` on the port's web page.

The JAX gate's ``bench`` step (``bench.py`` against a frames/s floor) is
not ported: it waits for the port's benchmark. Writes a table of the
steps (default ``build/signoff/RELEASE_CHECK.md``) and exits 0 only if
every step that was not skipped passed. With released files under
``--weights`` the sign-off steps verify the real bytes.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from .verify_release import OUT_DIR, REPO_ROOT

STEPS = ("tests", "multichip", "signoff", "mutate", "uilint")
TOOLS = "scrfd_arcface_facerecognition_tpu_torch.tools."


def step_commands(args):
    """(name, argv, timeout s) of every step, in order."""
    py = sys.executable
    dev = ["--device", args.device]
    return [
        ("tests", [py, "-m", "pytest", *sorted(_torch_tests()), "-q",
                   "-m", "not slow", "-p", "no:cacheprovider"], 3600),
        ("multichip", [py, "-m", TOOLS + "dryrun_multichip", "--slots", "8",
                       *dev], 900),
        ("signoff", [py, "-m", TOOLS + "verify_release", *dev, "--weights",
                     args.weights, "--out",
                     os.path.join(args.log_dir, "PARITY_gate.md")], 3600),
        ("mutate", [py, "-m", TOOLS + "verify_release", *dev, "--weights",
                    args.weights, "--mutate", "--out",
                    os.path.join(args.log_dir, "PARITY_gate_mutated.md")],
         3600),
        ("uilint", [py, "-m", TOOLS + "check_ui_js"], 120),
    ]


def _torch_tests():
    tests = os.path.join(REPO_ROOT, "tests")
    return [os.path.join("tests", f) for f in os.listdir(tests)
            if f.startswith("test_torch_") and f.endswith(".py")]


def run_step(name, argv, timeout_s, log_dir):
    log = os.path.join(log_dir, f"release_check_{name}.log")
    t0 = time.perf_counter()
    try:
        with open(log, "w") as f:
            rc = subprocess.run(argv, cwd=REPO_ROOT, stdout=f,
                                stderr=subprocess.STDOUT,
                                timeout=timeout_s).returncode
    except subprocess.TimeoutExpired:
        rc = -1
    with open(log) as f:
        tail = f.read()[-2000:]
    return {"name": name, "rc": rc,
            "seconds": round(time.perf_counter() - t0, 1), "log": log,
            "tail": tail}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--weights", default="./weights",
                    help="released .onnx directory for the sign-off steps")
    ap.add_argument("--skip", nargs="*", default=[], choices=list(STEPS))
    ap.add_argument("--log-dir", default=OUT_DIR)
    ap.add_argument("--out", default=None,
                    help="the report (default <log dir>/RELEASE_CHECK.md)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.log_dir, exist_ok=True)
    out = args.out or os.path.join(args.log_dir, "RELEASE_CHECK.md")
    results, ok = [], True
    for name, cmd, timeout_s in step_commands(args):
        if name in args.skip:
            results.append({"name": name, "rc": None, "seconds": 0,
                            "log": "", "tail": "(skipped)"})
            print(f"[gate] {name}: SKIPPED", flush=True)
            continue
        print(f"[gate] {name}: running ...", flush=True)
        r = run_step(name, cmd, timeout_s, args.log_dir)
        results.append(r)
        passed = r["rc"] == 0
        ok = ok and passed
        print(f"[gate] {name}: {'PASS' if passed else 'FAIL'} "
              f"({r['seconds']}s, log: {r['log']})", flush=True)
        if not passed:
            print(r["tail"][-800:], flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write("# Release gate of the PyTorch port\n\n"
                f"Command: `python -m {TOOLS}release_check` (device "
                f"{args.device}, weights {args.weights}, skipped: "
                f"{' '.join(args.skip) or 'none'})\n\n"
                "| step | verdict | seconds | log |\n|---|---|---|---|\n")
        for r in results:
            verdict = ("SKIP" if r["rc"] is None
                       else "PASS" if r["rc"] == 0 else "FAIL")
            f.write(f"| {r['name']} | {verdict} | {r['seconds']} | "
                    f"{r['log']} |\n")
        f.write(f"\n**Overall: {'PASS' if ok else 'FAIL'}**\n")
    print(f"[gate] overall: {'PASS' if ok else 'FAIL'} ({out} written)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
