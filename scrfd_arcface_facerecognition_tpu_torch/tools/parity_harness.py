"""Numerical parity of the port's graph executor against an oracle.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.parity_harness \
        [--device cpu] [--det det_10g.onnx --rec w600k_r50.onnx] [--images DIR]

The port's counterpart of the JAX repository's ``tools/parity_harness.py``:

- without ``--det`` / ``--rec``: the full-width ``TorchSCRFD()`` (det_10g)
  and ``TorchIResNet(blocks=(3, 4, 14, 3))`` (w600k_r50) stand-ins of
  ``tests/torch_export.py`` at seed 0 are exported to ONNX and run through
  the port's executor, against the stand-ins' own forward (on the CPU, in
  float32);
- with ``--det`` / ``--rec``: the executor against the port's importer
  (``config_from_graph.variables_from_onnx``) on the same file, two
  independent load paths of the same bytes.

Each frame is letterboxed to 640 x 640 for the detector (max |diff| over
its raw outputs) and center-cropped to 112 x 112 for the embedder (the
embedding cosine), as the reference prepares them (``tools/e2e_oracle``).
The frames are ``--n`` seeded synthetic ones of mixed sizes unless
``--images DIR`` names JPEGs (read with cv2). Exit 0 iff the detector is
within 1e-2 and the cosine above 1 - 1e-3. The executor and the importer
run in float32 with TF32 off; on the card unless ``--device cpu``.
"""
import argparse
import os
import sys

import numpy as np

from . import e2e_oracle as eo
from . import verify_release as vr

DET_BUDGET = 1e-2
COS_BUDGET = 1e-3


def standin_files(tmpdir: str):
    """The det_10g and w600k_r50 stand-ins at seed 0, exported under
    ``tmpdir``: ((det path, det module), (rec path, rec module))."""
    import torch

    te = vr.torch_export()
    os.makedirs(tmpdir, exist_ok=True)
    out = []
    for name, module, side in (
            ("det_10g", te.TorchSCRFD(), 640),
            ("w600k_r50", te.TorchIResNet(blocks=(3, 4, 14, 3)), 112)):
        module = te.seeded(module, 0).eval()
        path = os.path.join(tmpdir, f"{name}_synth.onnx")
        te.export_onnx(module, torch.randn(1, 3, side, side), path)
        out.append((path, module))
    return out


def compare(imgs, det_fwd, det_ref, rec_fwd, rec_ref):
    """(worst detector max |diff|, worst embedding cosine) over ``imgs``;
    a side whose forward is None is not compared."""
    worst_det, worst_cos = 0.0, 1.0
    for im in imgs:
        if det_fwd is not None:
            blob = eo.det_blob(eo.letterbox(im)[0])
            got, want = det_fwd(blob), det_ref(blob)
            if len(got) != len(want):
                raise SystemExit(f"detector: {len(got)} outputs, the "
                                 f"oracle {len(want)}")
            worst_det = max(worst_det, max(float(np.abs(g - w).max())
                                           for g, w in zip(got, want)))
        if rec_fwd is not None:
            blob = eo.rec_blob([eo.center_crop112(im)])
            worst_cos = min(worst_cos, vr.cosine(rec_fwd(blob),
                                                  rec_ref(blob)))
    return worst_det, worst_cos


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--images", default=None,
                    help="a directory of JPEGs (cv2); default synthetic")
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--det", default=None, help="a det_*.onnx file")
    ap.add_argument("--rec", default=None, help="a w600k_*.onnx file")
    ap.add_argument("--tmpdir", default=os.path.join(vr.OUT_DIR, "harness"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from ..device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.images:
        imgs = vr.load_images(args.images, args.n)
        if not imgs:
            print(f"no images under {args.images}")
            return 1
        print(f"{len(imgs)} images from {args.images}")
    else:
        imgs = eo.synthetic_frames(args.n)
        print(f"{len(imgs)} seeded synthetic frames")

    det_fwd = det_ref = rec_fwd = rec_ref = None
    if args.det is None and args.rec is None:
        (det_path, det_t), (rec_path, rec_t) = standin_files(args.tmpdir)
        print("full-width stand-in exports ready (torch oracle)")
        det_ref = eo.torch_det_forward(det_t)
        rec_ref = eo.torch_rec_forward(rec_t)
        det_fwd = vr.executor_forwards(det_path, True, device)
        rec_fwd = vr.executor_forwards(rec_path, False, device)
    else:
        if args.det:
            det_fwd = vr.executor_forwards(args.det, True, device)
            det_ref = vr.importer_forwards("det", args.det, device)
        if args.rec:
            rec_fwd = vr.executor_forwards(args.rec, False, device)
            rec_ref = vr.importer_forwards("rec", args.rec, device)

    worst_det, worst_cos = compare(imgs, det_fwd, det_ref, rec_fwd, rec_ref)
    print(f"detector raw-output max |executor - oracle|: {worst_det:.3e}")
    print(f"embedding worst cosine (executor vs oracle): {worst_cos:.6f}")
    ok = worst_det < DET_BUDGET and worst_cos > 1 - COS_BUDGET
    print("PARITY:", "OK (within the 1e-2 / 1e-3 budgets)" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
