"""The PQ codec's train budget against shortlist quality, on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.exp_train_budget \
        [--rows 1000000] [--queries 256] [--device cpu]

Port of the JAX repository's ``tools/exp_train_budget.py``. The dense ->
PQ crossing pays for training the codec and re-encoding every row. Since
``AutoGallery`` reranks the ADC shortlist exactly, a cheaper codec is
acceptable exactly when the shortlist still holds the right identity.
This sweep measures both sides on identity-structured rows (64 rows an
identity): for each (train rows, k-means iterations) of ``LADDER``, the
training and encoding seconds and top-1 identity of held-out queries
through ``PQGallery(keep_exact=True).search(k=1, rerank=32)``. It is why
``AutoGallery`` ships ``pq_train_rows=50_000, pq_train_iters=10``.

Prints the JAX tool's JSON lines. Runs on the card unless given
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Optional

import numpy as np

from . import synchronize

LADDER = ((100_000, 20), (50_000, 10), (25_000, 8), (12_500, 5))


def budget_rows(rows: int, queries: int, seed: int = 0, d: int = 512):
    """The JAX tool's draws: (rows, d) unit rows of rows // 64 identities
    (owner), and (queries, d) fresh jittered views of identities q_ident.
    Returns (mat, owner, q, q_ident)."""
    rng = np.random.default_rng(seed)
    n_ident = rows // 64
    centers = rng.normal(size=(n_ident, d)).astype(np.float32)
    owner = rng.integers(0, n_ident, size=rows)
    mat = centers[owner] + 0.3 * rng.normal(size=(rows, d)).astype(
        np.float32)
    mat /= np.linalg.norm(mat, axis=1, keepdims=True)
    q_ident = rng.integers(0, n_ident, size=queries)
    q = centers[q_ident] + 0.3 * rng.normal(size=(queries, d)).astype(
        np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return mat, owner, q, q_ident


def evaluate(codec, mat, owner, q, q_ident):
    """Encode every row with ``codec`` into a keep_exact PQGallery on the
    codec's device and search the queries at k=1, rerank=32. Returns
    (queries whose top-1 row has their identity, encode seconds)."""
    from ..gallery.pq import PQGallery

    dev = codec.device
    g = PQGallery(codec, capacity=len(mat) + 8, keep_exact=True, device=dev)
    t0 = time.perf_counter()
    g.add(np.arange(len(mat), dtype=np.int64), mat)
    synchronize(dev)
    encode_s = time.perf_counter() - t0
    _, ids = g.search(q, k=1, rerank=32)
    hit = sum(1 for qi in range(len(q))
              if ids[qi][0] >= 0 and owner[int(ids[qi][0])] == q_ident[qi])
    return hit, encode_s


def run(rows: int = 1_000_000, queries: int = 256, device=None,
        emit: Callable[[dict], None] = None) -> list:
    """One JSON line a rung of ``LADDER`` to ``emit``; returns the lines
    with each rung's hit count."""
    from ..device import resolve_device
    from ..gallery.pq import PQCodec

    emit = emit or (lambda line: print(json.dumps(line), flush=True))
    dev = resolve_device(device)
    mat, owner, q, q_ident = budget_rows(rows, queries)
    out = []
    for train_rows, iters in LADDER:
        synchronize(dev)
        t0 = time.perf_counter()
        codec = PQCodec.train(mat[:train_rows], m=64, k=256, iters=iters,
                              device=dev)
        synchronize(dev)
        t_train = time.perf_counter() - t0
        hit, t_encode = evaluate(codec, mat, owner, q, q_ident)
        line = {"train_rows": train_rows, "iters": iters,
                "train_s": round(t_train, 1),
                "encode_s": round(t_encode, 1),
                "top1_identity": f"{hit}/{queries}"}
        emit(line)
        out.append(dict(line, hits=hit, train_s_exact=t_train,
                        encode_s_exact=t_encode))
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(args.rows, args.queries, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
