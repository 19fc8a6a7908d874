"""The duplicate scan over a million-row gallery, on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.exp_merge_1m \
        [--g 1000000] [--dups 2000] [--threshold 0.95] [--device cpu]

Port of the JAX repository's ``tools/exp_merge_1m.py``. Builds a G-row
gallery with planted near-duplicate pairs (row G - dups + i is row i plus
a 0.01 jitter, cosine about 0.999), runs the blocked duplicate scan
(``gallery.dedup.find_duplicate_pairs_blocked``, the formulation
``AutoGallery.duplicate_groups`` uses past 8k rows) and checks that exactly
the planted pairs come back; then the merge worklist, a union-find over
the pairs (``runtime.native.uf_group_roots``). The one-shot G x G scan
would need a 4 TB matrix at this scale.

Prints the JAX tool's JSON lines; exits 1 unless the pairs found equal the
planted ones. Runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Optional

import numpy as np

from . import synchronize


def planted_rows(g: int, dups: int, seed: int = 0):
    """(G, 512) unit rows, row G - dups + i a jittered copy of row i, and
    G - dups: the JAX tool's draws."""
    rng = np.random.default_rng(seed)
    n_unique = g - dups
    rows = rng.normal(size=(g, 512)).astype(np.float32)
    rows[n_unique:] = rows[:dups] + 0.01 * rng.normal(
        size=(dups, 512)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows, n_unique


def run(g: int = 1_000_000, dups: int = 2000, threshold: float = 0.95,
        device=None, emit: Callable[[dict], None] = None) -> dict:
    """The scan and the merge; each JSON line goes to ``emit``. Returns
    the lines' figures with the pairs and the union-find roots."""
    from ..device import resolve_device
    from ..gallery.dedup import find_duplicate_pairs_blocked
    from ..runtime.native import uf_group_roots

    emit = emit or (lambda line: print(json.dumps(line), flush=True))
    dev = resolve_device(device)
    emit({"note": f"building {g} rows ({dups} planted duplicates)"})
    rows, n_unique = planted_rows(g, dups)

    synchronize(dev)
    t0 = time.perf_counter()
    # the scan reads every block's candidates back: its time is of
    # finished device work
    pairs = find_duplicate_pairs_blocked(rows, threshold, device=dev)
    scan_s = time.perf_counter() - t0
    want = {(i, n_unique + i) for i in range(dups)}
    got = {(a, b) for a, b, _ in pairs}
    ok = got == want
    emit({"metric": f"blocked_dedup_scan_s (G={g}, {dups} planted pairs, "
                    f"thr={threshold})",
          "value": round(scan_s, 2), "unit": "s",
          "pairs_found": len(got), "exact_match": ok})

    t0 = time.perf_counter()
    idx_pairs = np.asarray([(a, b) for a, b, _ in pairs], np.int64)
    roots = uf_group_roots(g, idx_pairs)
    n_groups = int(g - (roots != np.arange(g)).sum())
    merge_s = time.perf_counter() - t0
    emit({"metric": f"merge_unionfind_s (G={g})",
          "value": round(merge_s, 3), "unit": "s",
          "groups_after_merge": n_groups})
    return dict(scan_s=scan_s, pairs_found=len(got), exact_match=ok,
                merge_s=merge_s, groups_after_merge=n_groups, pairs=got,
                missed=sorted(want - got), extra=sorted(got - want),
                roots=roots)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--g", type=int, default=1_000_000)
    ap.add_argument("--dups", type=int, default=2000)
    ap.add_argument("--threshold", type=float, default=0.95)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.g, args.dups, args.threshold, args.device)
    return 0 if res["exact_match"] else 1


if __name__ == "__main__":
    sys.exit(main())
