"""Export a (trained) model to ONNX: the deploy end of train -> serve.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.export_onnx \
        --variant w600k_mbf --checkpoint ckpt/step_1000.pt \
        --out weights/w600k_mbf.onnx --verify

Writes a ``.onnx`` file with the released files' I/O contract (the
nine-output detector, the single 512-d embedder), which the reference's
onnxruntime stack, the port's graph executor (``models/onnx_exec.py``) or
any ONNX runtime runs. ``--checkpoint`` is a ``torch.save`` file of the
port's trainer (``tools.train_arcface``) or of raw variables; without it
the model exports at its seeded initialization (``--seed``), a check of
the graph's structure.

``--verify`` loads the written file through the graph executor and holds
it to the module's own forward at f32 (TF32 off) on a random input:
embedding cosine >= 1 - 1e-4, detector outputs within 1e-3 of their
largest magnitude. Runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np

DETECTORS = ("det_500m", "det_2.5g", "det_10g")
EMBEDDERS = ("w600k_r50", "w600k_mbf")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Export a model to the released files' ONNX format")
    ap.add_argument("--variant", required=True,
                    choices=DETECTORS + EMBEDDERS)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="a checkpoint file (tools.train_arcface output); "
                         "omit to export the seeded initialization")
    ap.add_argument("--out", type=str, default=None,
                    help="output path (default <variant>.onnx)")
    ap.add_argument("--verify", action="store_true",
                    help="run the written file through the graph executor "
                         "and compare it with the module's forward")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def verify(path: str, module, is_det: bool, seed: int, device) -> float:
    """The file through the executor against ``module`` at f32 on one
    seeded input: the embedding cosine, or the worst detector output error
    relative to its largest magnitude. Raises SystemExit when it fails."""
    import torch

    from ..device import full_f32
    from ..models.onnx_exec import onnx_model

    shape = (1, 3, 224, 224) if is_det else (1, 3, 112, 112)
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)).to(device)
    graph = onnx_model(path, device=device)
    with torch.no_grad(), full_f32():
        got = [o.float().cpu().numpy() for o in graph(x)]
        ref = module.eval()(x)
    if is_det:
        ref = [o.cpu().numpy()
               for o in ref["scores"] + ref["bboxes"] + ref["kps"]]
        # relative: random weights give unbounded activations
        worst = max(float(np.abs(g - r).max())
                    / max(1.0, float(np.abs(r).max()))
                    for g, r in zip(got, ref))
        print(f"verify: {len(got)} outputs, worst relative |module - onnx| "
              f"= {worst:.2e}")
        if worst > 1e-3:
            raise SystemExit("verification FAILED (relative diff above 1e-3)")
        return worst
    g = got[0].reshape(-1)
    r = ref.cpu().numpy().reshape(-1)
    cos = float(np.dot(g, r) / max(np.linalg.norm(g) * np.linalg.norm(r),
                                   1e-30))
    print(f"verify: embedding cosine(module, onnx) = {cos:.7f}")
    if cos < 1 - 1e-4:
        raise SystemExit("verification FAILED (cosine below 1 - 1e-4)")
    return cos


def main(argv=None) -> str:
    """Export as the arguments say; returns the written path."""
    args = parse_args(argv)
    from ..device import resolve_device
    from ..models.arcface import build_arcface
    from ..models.checkpoints import load_inference_variables
    from ..models.init_utils import seeded_init_
    from ..models.onnx_export import export_model
    from ..models.scrfd import build_scrfd
    from ..models.weights import load_flax_variables

    device = resolve_device(args.device)
    is_det = args.variant in DETECTORS
    module = build_scrfd(args.variant) if is_det else build_arcface(
        args.variant)
    if args.checkpoint:
        load_flax_variables(module, load_inference_variables(args.checkpoint))
    else:
        seeded_init_(module, args.seed)
        print(f"note: no --checkpoint; exporting {args.variant} at its "
              "seeded initialization")
    out_path = args.out or f"{args.variant}.onnx"
    data = export_model(module, path=out_path)
    print(f"wrote {out_path} ({len(data) / 1e6:.2f} MB)")
    if args.verify:
        verify(out_path, module.to(device), is_det, args.seed, device)
    return out_path


if __name__ == "__main__":
    main()
