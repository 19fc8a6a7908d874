"""The port's benchmark: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads and warms up the cell's program, drives its traffic for
``--seconds``, judges what the timed path produced against the plain
reference, and prints one JSON line last: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` (and ``breakdown`` when
traced), then ``checks``, each compared number beside its limit. The same
numbers are the last lines of standard error. Without a CUDA card, or
with fewer cards than the cell asks for, it exits 2 and prints no result.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, is where imports start
sys.path[0] = str(ROOT)
# build and kernel caches of libraries the program may load: inside the
# checkout, at fixed paths (the port builds its own kernels into
# build/torch_kernels, a fixed path of the checkout)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import core, harness

    spec = core.load_spec()
    cell = core.cell(spec, args.workload)
    try:
        torch = core.check_card(cell["chips"])
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    ctx = harness.context(spec, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda"), STARTED)
    out = harness.run_cell(
        spec, ctx, lambda peak: core.device_info(torch, cell["chips"], peak))
    return harness.emit(out)


if __name__ == "__main__":
    sys.exit(main())
