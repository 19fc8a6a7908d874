"""Where kernel K1's time goes: ``csrc/warp_align.cu`` built with one part
taken out or one choice changed, each variant timed on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.warp_align_ablate

Each variant is a text edit of the source, checked to apply exactly once,
built with nvcc (``cuda_build.build_variants``) into
``build/torch_kernels/ablate/`` and bound with ctypes like the kernel:

- ``full``: the kernel as it is;
- ``one_cta_per_crop``: one CTA walks all of a crop's tiles (the grid of
  the kernel's first design, with the new work a thread);
- ``quad_cols``: each thread computes the 4 consecutive pixels it stores
  (a warp's load then spans pixels 4 apart) instead of pixels 28 apart;
- ``direct_stores``: each pixel stored from its thread's registers as a
  scalar, with no pass through the shared-memory tile;
- ``scalar_stores``: through the tile, but each plane's four pixels
  stored as four scalars instead of one float4;
- ``rows2``: tiles of 2 rows (56 threads) instead of 4 (112);
- ``rows8``: tiles of 8 rows (224 threads);
- ``no_load``: the taps read constants (no source access at all, so no
  staging of the source could save more than ``full - no_load``);
- ``no_store``: the crops computed but not stored (a store that never runs
  keeps them live).

``full``, ``one_cta_per_crop``, ``quad_cols``, ``direct_stores``,
``scalar_stores``, ``rows2`` and ``rows8`` compute the crops and are
checked bit for bit against ``warp_align_plain``; the others give wrong
crops, and only their times are read. Times are device ms per call on face-like crops (``workload``)
at ``SHAPES``: 80 crops over 8 x 1080p frames (the main path's batch)
rotated up to 30 deg, the same at any rotation, and 320 crops over 16;
warm (back to back, ``tools.device_ms``) and cold (the 50 MB L2 flushed
before each call, as ``chip_smoke.py`` times K1), the variants in turns,
over two rounds. Each variant's occupancy (threads and rows a CTA,
resident CTAs an SM, registers) is printed beside it.
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
from ..ops import warp_align as wa
from . import device_ms

_STORE4 = ("  *reinterpret_cast<float4*>(p) = "
           "*reinterpret_cast<const float4*>(t);\n")
_SCALAR = "              p[k] = tile[c][r][kQuad * q + k];"

VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "full": [],
    "one_cta_per_crop": [("const dim3 grid(tiles, ", "const dim3 grid(1, ")],
    "quad_cols": [("{ return q + kQuads * k; }", "{ return kQuad * q + k; }")],
    "direct_stores": [
        ("            tile[c][r][tile_col(q, k)] = res[c][k];",
         "            if (c0 + tile_col(q, k) < OW)\n"
         "              dst[(size_t)c * npix + (size_t)i * OW + c0 +\n"
         "                  tile_col(q, k)] = res[c][k];"),
        ("      if (i < OH && j0 < OW) {", "      if (false) {")],
    "scalar_stores": [(_STORE4, "  for (int k = 0; k < 4; ++k) p[k] = t[k];\n")],
    "rows2": [("kRows = 4;", "kRows = 2;")],
    "rows8": [("kRows = 4;", "kRows = 8;")],
    "no_load": [("(float)__ldg(src + (size_t)pix[k][t] * 3 + c)",
                 "(float)(c + t + k)")],
    "no_store": [(_STORE4, "  if (t[0] + t[1] + t[2] + t[3] == 1234.5f)\n"
                           + _STORE4),
                 (_SCALAR, "              if (tile[c][r][kQuad * q + k] == "
                           "1234.5f)\n  " + _SCALAR)],
}
EXACT = ("full", "one_cta_per_crop", "quad_cols", "direct_stores",
         "scalar_stores", "rows2", "rows8")
# (frames, crops, largest rotation in degrees) of the timed workloads: the
# main path's batch, the same with crops at any rotation (as the seeded
# main path's random landmarks give), and 320 crops
SHAPES = ((8, 80, 30), (8, 80, 180), (16, 320, 30))


def variant_source(name: str) -> str:
    """The kernel's source with variant ``name``'s edits applied; raises
    if an edit's text is not found exactly once."""
    src = cuda_build.source_path(wa.NAME).read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: edit target found "
                             f"{src.count(old)} times: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names=tuple(VARIANTS)) -> Dict[str, ctypes.CDLL]:
    """Build the variants with nvcc, all at once; returns each one's
    loaded library."""
    libs = cuda_build.build_variants(
        wa.NAME, {n: variant_source(n) for n in names})
    return {n: ctypes.CDLL(str(p)) for n, p in libs.items()}


def workload(rng: np.random.Generator, nb: int, crops: int, h: int = 1080,
             w: int = 1920, device="cpu", max_deg: float = 30.0):
    """Smooth u8 BGR frames (nb, h, w, 3) and ``crops`` face-like crops
    over them: source/dest scale 0.5-2 (faces of 56-224 source px),
    rotations within ``max_deg``, centers inside the frame, crop i from frame
    i % nb. Returns frames, the (F, 2, 3) f32 dst -> src matrices and the
    (F,) int32 frame indices."""
    low = rng.uniform(0, 255, (nb, 3, max(h // 16, 2), max(w // 16, 2)))
    big = torch.nn.functional.interpolate(
        torch.from_numpy(low.astype(np.float32)), size=(h, w),
        mode="bilinear", align_corners=False)
    frames = big.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    sigma = rng.uniform(0.5, 2.0, crops)
    ang = np.deg2rad(rng.uniform(-max_deg, max_deg, crops))
    cx = rng.uniform(0.1 * w, 0.9 * w, crops)
    cy = rng.uniform(0.1 * h, 0.9 * h, crops)
    a, b = sigma * np.cos(ang), sigma * np.sin(ang)
    minv = np.stack([np.stack([a, -b, cx - 55.5 * (a - b)], 1),
                     np.stack([b, a, cy - 55.5 * (a + b)], 1)], 1)
    fidx = (np.arange(crops) % nb).astype(np.int32)
    return (frames.contiguous().to(device),
            torch.from_numpy(minv.astype(np.float32)).to(device),
            torch.from_numpy(fidx).to(device))


def cold_ms(fn, iters: int, dev: torch.device) -> float:
    """Mean device ms of fn() over ``iters`` calls, each after a 64 MB
    write that flushes the L2 and a device-side spin that covers the
    host's launch."""
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    fn()
    torch.cuda.synchronize(dev)
    total = 0.0
    for _ in range(iters):
        scratch.zero_()
        torch.cuda._sleep(10_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def run(iters: int = 20, device=None) -> Dict:
    """Per workload (frames, crops): each variant's warm and cold device
    ms a call (the mean of two rounds taken in turns); each variant's
    occupancy; whether the computing variants were bit-equal to the plain
    version on every workload."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("warp_align_ablate times the kernel on the card")
    libs = build()
    fns: Dict[str, Callable] = {n: wa.launch_function(lib)
                                for n, lib in libs.items()}
    occ = {n: wa.occupancy(lib) for n, lib in libs.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    res: Dict = {"occupancy": occ, "exact": True, "ms": {}}
    for nb, f, deg in SHAPES:
        frames, minv, fidx = workload(rng, nb, f, device=dev, max_deg=deg)
        b, h, w, _ = frames.shape
        out = torch.empty((f, 3, 112, 112), dtype=torch.float32, device=dev)

        def call(fn):
            rc = fn(frames.data_ptr(), b, h, w, minv.data_ptr(),
                    fidx.data_ptr(), f, out.data_ptr(), 112, 112, stream)
            if rc != 0:
                raise RuntimeError(f"warp_align variant launch failed: "
                                   f"CUDA error {rc}")

        want = wa.warp_align_plain(frames, minv, fidx)
        for n in EXACT:
            out.fill_(float("nan"))
            call(fns[n])
            torch.cuda.synchronize(dev)
            res["exact"] &= bool(torch.equal(out, want))
        ms = {(n, how): 0.0 for n in fns for how in ("warm", "cold")}
        for order in (list(fns), list(fns)[::-1]):
            for n in order:
                ms[(n, "warm")] += device_ms(lambda: call(fns[n]), iters,
                                             dev) / 2
                ms[(n, "cold")] += cold_ms(lambda: call(fns[n]), iters,
                                           dev) / 2
        res["ms"][(nb, f, deg)] = ms
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    res = run(args.iters)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    name = card[0] if card else torch.cuda.get_device_name(0)
    print(f"K1 variants [{name}]; {', '.join(EXACT)} bit-equal to the plain "
          f"version on every workload: {res['exact']}")
    for n, o in res["occupancy"].items():
        print(f"  {n:16s} {o['threads']} threads x {o['rows']} rows a CTA, "
              f"{o['blocks_per_sm']} CTAs an SM, {o['regs']} registers")
    for (nb, f, deg), ms in res["ms"].items():
        print(f"K1 variants at {nb} x 1080p, {f} face-like crops rotated "
              f"up to {deg} deg, device ms "
              f"a call, warm / cold L2 [{name}]:")
        for n in VARIANTS:
            tw, tc = ms[(n, "warm")], ms[(n, "cold")]
            print(f"  {n:16s} {tw:.4f} / {tc:.4f}  (full - {n}: "
                  f"{ms[('full', 'warm')] - tw:+.4f} / "
                  f"{ms[('full', 'cold')] - tc:+.4f})")


if __name__ == "__main__":
    main()
