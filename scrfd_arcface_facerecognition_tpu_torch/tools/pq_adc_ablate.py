"""Where kernel K2's time goes: ``csrc/pq_adc.cu`` built with one part
taken out or one choice changed, each variant timed at the gallery path's
shapes on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.pq_adc_ablate

Each variant is a text edit of the source, checked to apply exactly once,
built with nvcc (``cuda_build.build_variants``) into
``build/torch_kernels/ablate/`` and bound with ctypes like the kernel:

- ``full``: the kernel as it is;
- ``no_lookup``: codes read and scores stored, but each add takes the
  code's own offset instead of the table's entry (no shared-memory loads);
- ``no_store``: the score stores removed, the sums kept live by a store
  that never runs (a later slab then starts from whatever ``out`` holds);
- ``lookup_only``: no code loads and no score stores: the table lookups
  over codes hashed in registers from the row and subspace, the sums kept
  live as in ``no_store``;
- ``no_stage``: the tables not staged (the lookups read whatever shared
  memory holds);
- ``stage_scalar``: the tables staged one record a thread from 4-byte LUT
  loads instead of four records from 16-byte loads;
- ``rows1``: one code row in flight a thread instead of two;
- ``slab_max``: slabs as large as fit (48 + 16 subspaces at M=64) instead
  of equal ones (32 + 32);
- ``hi_w4``: "hi" groups of 4 bf16 (8-byte loads, one slab, 20 chunks)
  instead of 8 (16-byte loads, two slabs, 10 chunks);
- ``hilo_w2``: "hilo" groups of 2 f32 (8-byte loads, one slab, 40 chunks)
  instead of 4;
- ``w_max``: the widest group (8 "hi", 4 "hilo") at every Q, instead of
  the least power of two >= Q.

``full``, ``stage_scalar``, ``rows1``, ``slab_max``, ``hi_w4``,
``hilo_w2`` and ``w_max`` compute the scores and are checked bit for bit
against ``adc_scores_plain`` in each precision; the others give wrong
scores, and only their times are read. Times are device ms per call, warm,
back to back (``tools.device_ms``), at Q=80, M=64, K=256, G=2,000,000,
uniform random codes, in both precisions, the variants in turns, over two
rounds. Then ``full`` and ``w_max`` at Q of ``SMALL_Q`` (one query's
search, and a few), checked and timed the same way; and ``full`` at Q=80
on the same codes with rows G/2 on all zero: the gallery path's PQ tier,
whose 2,000,000-row capacity holds 1,000,000 rows and which is scored
whole.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .. import cuda_build
from ..device import resolve_device
from ..gallery import pq_adc
from . import device_ms

SHAPES = dict(q=80, m=64, k=256, g=2_000_000)
# variants that still compute the scores, and are checked
EXACT = ("full", "stage_scalar", "rows1", "slab_max", "hi_w4", "hilo_w2",
         "w_max")
# the small-Q comparison: the group width chosen from Q against the widest
SMALL_Q = (1, 2, 4)
SMALL_Q_VARIANTS = ("full", "w_max")

_NO_STORE = ("if (ok[r] && q < nq) out[",
             "if (ok[r] && q < nq && acc[r][q] == 1234.5f) out[")
_HASH = ("template <bool VEC>\n__device__ __forceinline__ void load_codes(",
         "__device__ __forceinline__ unsigned mix_(unsigned h) {\n"
         "  h ^= h >> 16; h *= 0x85ebca6bu; h ^= h >> 13; h *= 0xc2b2ae35u;\n"
         "  return h ^ (h >> 16);\n}\n\n"
         "template <bool VEC>\n__device__ __forceinline__ void load_codes(")
_CODES = ("v = __ldg(reinterpret_cast<const uint4*>(row[r] + m0 + 16 * h));",
          "{ const unsigned h_ = (unsigned)(uintptr_t)row[r] + m0 + 16 * h;\n"
          "  v = make_uint4(mix_(h_), mix_(h_ + 4u), mix_(h_ + 8u),\n"
          "                 mix_(h_ + 12u)); }")

VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "full": [],
    "no_lookup": [("Grp::load(tj + c * GB, w);",
                   "for (int x_ = 0; x_ < Grp::kWords; ++x_)\n"
                   "  w[x_] = (uint32_t)(c * GB) + x_;")],
    "no_store": [_NO_STORE],
    "lookup_only": [_NO_STORE, _HASH, _CODES],
    "no_stage": [("stage<HI, W>(table, lut",
                  "if (0) stage<HI, W>(table, lut")],
    "stage_scalar": [("const bool vec_lut = K % 4 == 0 && ",
                      "const bool vec_lut = false && K % 4 == 0 && ")],
    "rows1": [("constexpr int kRows = 2;", "constexpr int kRows = 1;")],
    "slab_max": [("    ms = (M + nslab - 1) / nslab;\n",
                  "    (void)nslab;\n")],
    "hi_w4": [("constexpr int kHiMaxW = 8;", "constexpr int kHiMaxW = 4;")],
    "hilo_w2": [("constexpr int kLoMaxW = 4;", "constexpr int kLoMaxW = 2;")],
    "w_max": [("const int want = Q;", "const int want = MaxW;")],
}


def variant_source(name: str) -> str:
    """The kernel's source with variant ``name``'s edits applied; raises
    if an edit's text is not found exactly once."""
    src = cuda_build.source_path(pq_adc.NAME).read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: edit target found "
                             f"{src.count(old)} times: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names=None) -> Dict[str, Callable]:
    """Build the variants (all by default) with nvcc, all at once; returns
    each one's launch function, typed as ``pq_adc_launch``."""
    libs = cuda_build.build_variants(
        pq_adc.NAME, {n: variant_source(n) for n in names or VARIANTS})
    return {n: pq_adc.launch_function(ctypes.CDLL(str(p)))
            for n, p in libs.items()}


def workload(rng: np.random.Generator, q: int, m: int, k: int, g: int,
             device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A normal (Q, M, K) f32 LUT and uniform (G, M) u8 codes."""
    lut = torch.from_numpy(rng.normal(size=(q, m, k)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, k, (g, m), dtype=np.uint8))
    return lut.to(device), codes.to(device)


def run(iters: int = 10, device=None, shapes=None) -> Dict[str, dict]:
    """Device ms per call, the mean of two rounds taken in turns, and
    whether the computing variants equal the plain version bit for bit:
    ``ms[(variant, precision)]`` at ``SHAPES``; ``small[(q, variant,
    precision)]`` at each Q of ``SMALL_Q``; ``half_empty[precision]``,
    ``full`` on codes whose second half is zero; ``exact[precision]``,
    over every checked call."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("pq_adc_ablate times the kernel on the card")
    s = dict(SHAPES, **(shapes or {}))
    fns = build()
    lut, codes = workload(np.random.default_rng(0), s["q"], s["m"], s["k"],
                          s["g"], dev)
    out = torch.empty((s["q"], s["g"]), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(fn, hi, lut_, codes_):
        rc = fn(lut_.data_ptr(), codes_.data_ptr(), out.data_ptr(),
                lut_.shape[0], s["m"], s["k"], codes_.shape[0], hi, stream)
        if rc != 0:
            raise RuntimeError(f"pq_adc variant launch failed: CUDA error "
                               f"{rc}")

    def timed(keys, args):
        """Each key's (variant, precision, lut, codes) timed in turns, the
        order reversed in the second round."""
        ms = dict.fromkeys(keys, 0.0)
        for order in (list(keys), list(keys)[::-1]):
            for key in order:
                n, p, lut_, codes_ = args(key)
                hi = int(p == "hi")
                ms[key] += device_ms(lambda: call(fns[n], hi, lut_, codes_),
                                     iters, dev) / 2
        return ms

    exact = {p: True for p in pq_adc.PRECISIONS}

    def check(names, lut_, codes_):
        for p in pq_adc.PRECISIONS:
            want = pq_adc.adc_scores_plain(lut_, codes_, p).view(torch.int32)
            for n in names:
                call(fns[n], int(p == "hi"), lut_, codes_)
                got = out[:lut_.shape[0]].view(torch.int32)
                exact[p] = exact[p] and torch.equal(got, want)
            del want

    small_luts = {q: lut[:q].contiguous() for q in SMALL_Q}
    check(EXACT, lut, codes)
    for q in SMALL_Q:
        check(SMALL_Q_VARIANTS, small_luts[q], codes)
    half = codes.clone()
    half[s["g"] // 2:] = 0
    check(("full",), lut, half)

    ms = timed([(n, p) for n in fns for p in pq_adc.PRECISIONS],
               lambda key: (*key, lut, codes))
    small = timed([(q, n, p) for q in SMALL_Q for n in SMALL_Q_VARIANTS
                   for p in pq_adc.PRECISIONS],
                  lambda key: (key[1], key[2], small_luts[key[0]], codes))
    half_empty = timed(list(pq_adc.PRECISIONS),
                       lambda p: ("full", p, lut, half))
    return dict(ms=ms, small=small, half_empty=half_empty, exact=exact)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    r = run(args.iters)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    name = card[0] if card else torch.cuda.get_device_name(0)
    s = SHAPES
    print(f"K2 variants at Q={s['q']} M={s['m']} K={s['k']} G={s['g']}, "
          f"device ms a call (warm) [{name}]; {', '.join(EXACT)} bit-equal "
          f"to the plain scan (all the checked calls): "
          + ", ".join(f"{p} {r['exact'][p]}" for p in pq_adc.PRECISIONS))
    ms = r["ms"]
    for p in pq_adc.PRECISIONS:
        full = ms[("full", p)]
        for n in VARIANTS:
            t = ms[(n, p)]
            print(f"  {p:4s} {n:12s} {t:.4f}  (full - {n}: {full - t:+.4f})")
    print("Small Q, same codes: the group width chosen from Q (full) and the "
          "widest (w_max)")
    for (q, n, p), t in sorted(r["small"].items()):
        print(f"  Q={q} {p:4s} {n:6s} {t:.4f}")
    print(f"full at Q={s['q']} on the same codes with rows {s['g'] // 2}.. "
          f"all zero (the gallery path's half-filled tier): "
          + ", ".join(f"{p} {t:.4f}" for p, t in r["half_empty"].items()))


if __name__ == "__main__":
    main()
