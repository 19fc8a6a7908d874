"""SCRFD detector training from the command line, meshed over the cards.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.train_scrfd \
        --labels /data/wider/train/label.txt \
        --val-labels /data/wider/val/label.txt \
        --variant det_500m --batch 32 --epochs 3 --out ckpt/

``--labels`` is a retinaface-format ``label.txt`` (WIDER FACE's
annotations); its images are read by ``train.detection_data.read_image``
(cv2 where it is installed; a caller may replace it), letterboxed to
``--input-size`` and batched with the faces padded to ``--max-gt``. For a
check of the machinery without a dataset, ``--synthetic N`` trains N
steps on synthetic batches (random images, plausible face boxes). The
checkpoint is a ``torch.save`` file of the detector's variables
(``<out>/step_<N>.pt``) that ``models.checkpoints.load_inference_variables``
and ``tools.export_onnx --checkpoint`` read. ``--val-labels`` reports
AP@0.5 of the trained detector.

The batch splits over every card (``--device cuda``, the default), as the
JAX tool's 'data' mesh, or over ``--slots N`` slots that share
``--device`` (one card's, or the CPU's with ``--device cpu``). One slot
is the one-device trainer.
"""
import argparse
import os
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train an SCRFD detector")
    ap.add_argument("--labels", type=str, default=None,
                    help="retinaface-format label.txt (WIDER FACE)")
    ap.add_argument("--val-labels", type=str, default=None)
    ap.add_argument("--images-root", type=str, default=None)
    ap.add_argument("--variant", type=str, default="det_500m",
                    choices=["det_500m", "det_2.5g", "det_10g"])
    ap.add_argument("--input-size", type=int, default=640)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--decay-steps", type=int, default=None,
                    help="anneal the lr to ~0 over this many steps after "
                         "the warmup")
    ap.add_argument("--lr-decay", type=str, default="cosine",
                    choices=["poly", "cosine"])
    ap.add_argument("--max-gt", type=int, default=32)
    ap.add_argument("--out", type=str, default="scrfd_ckpt")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="train on N synthetic batches instead of a dataset")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--slots", type=int, default=None,
                    help="mesh over N slots that share --device (default: "
                         "one a card for cuda, one for any other device)")
    args = ap.parse_args(argv)
    if not args.synthetic and not args.labels:
        ap.error("--labels or --synthetic required")
    return args


def main(argv=None) -> str:
    """Train as the arguments say; returns the checkpoint's path."""
    args = parse_args(argv)
    import torch

    from ..models.scrfd import build_scrfd
    from ..train import (SCRFDLossConfig, SCRFDTrainer,
                         batches_from_annotations, parse_wider_annotations,
                         synthetic_detection_batch)

    from .train_arcface import training_mesh

    size = (args.input_size, args.input_size)
    mesh = training_mesh(args.device, args.slots, axis_names=("data",))
    trainer = SCRFDTrainer(model=build_scrfd(args.variant),
                           loss_cfg=SCRFDLossConfig(input_size=size),
                           learning_rate=args.lr,
                           warmup_steps=args.warmup_steps,
                           decay_steps=args.decay_steps,
                           lr_decay=args.lr_decay,
                           device=None if mesh else args.device, mesh=mesh)
    state = trainer.init_state(0)
    layout = "" if mesh is None else f" mesh=data:{mesh.shape['data']}"
    print(f"device={trainer.device}{layout} variant={args.variant} "
          f"input={size}", flush=True)
    t0 = time.time()

    def run(images, gt_boxes, gt_kps, gt_valid, gt_kps_valid=None):
        nonlocal state
        nchw = np.ascontiguousarray(images.transpose(0, 3, 1, 2))
        state, loss, m = trainer.train_step(
            state, torch.from_numpy(nchw), gt_boxes, gt_kps, gt_valid,
            gt_kps_valid)
        if state.step % args.log_every == 0 or state.step == 1:
            print(f"step {state.step:6d}  loss {float(loss):8.4f}  "
                  f"cls {float(m['cls']):.4f} box {float(m['box']):.4f} "
                  f"kps {float(m['kps']):.4f}  n_pos {int(m['n_pos'])}  "
                  f"{time.time() - t0:.1f}s", flush=True)

    if args.synthetic:
        rng = np.random.default_rng(0)
        for _ in range(args.synthetic):
            run(*synthetic_detection_batch(rng, args.batch, size,
                                           max_gt=args.max_gt))
    else:
        anns = parse_wider_annotations(args.labels, args.images_root)
        print(f"{len(anns)} annotated images", flush=True)
        for epoch in range(args.epochs):
            for batch in batches_from_annotations(
                    anns, args.batch, size, args.max_gt, seed=epoch):
                run(*batch)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"step_{state.step}.pt")
    trainer.save_checkpoint(state, path)
    print(f"saved {path}")

    if args.val_labels:
        from ..models.checkpoints import load_inference_variables
        from ..pipeline import Detector
        from ..train import evaluate_detector

        det = Detector(args.variant, variables=load_inference_variables(path),
                       input_size=size, device=trainer.device)
        val = parse_wider_annotations(args.val_labels, args.images_root)
        out = evaluate_detector(det, val)
        print(f"val AP@0.5 = {out['ap']:.4f} over {out['images']} images")
    return path


if __name__ == "__main__":
    main()
