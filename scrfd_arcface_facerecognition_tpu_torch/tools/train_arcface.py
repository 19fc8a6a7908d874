"""ArcFace embedder training from the command line, meshed over the cards.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.train_arcface \
        --data /data/faces --variant w600k_mbf --batch 64 --epochs 2 \
        --sample-rate 0.2 --out ckpt/

``--data`` expects the identity-folder layout (<root>/<id>/*.jpg); images
are resized to 112x112 and normalized (x - 127.5) / 127.5, the inference
contract. They are read by ``read_image`` (cv2 where it is installed; a
caller may replace it). ``--sample-rate`` < 1 turns on Partial FC
(arXiv:2010.05222). For a check of the machinery without a dataset,
``--synthetic N`` trains N steps on random images over ``--num-classes``
identities. The checkpoint is a ``torch.save`` file (``<out>/step_<N>.pt``)
that ``models.checkpoints.load_inference_variables`` and
``tools.export_onnx --checkpoint`` read.

The trainer meshes over every card (``--device cuda``, the default) or
over ``--slots N`` slots that share ``--device`` (one card's, or the
CPU's with ``--device cpu``): ``--model-shards`` of them split the class
matrix ('model'), the rest of the factor splits the batch ('data'), as
the JAX tool's mesh. One slot is the one-device trainer.
"""
import argparse
import os
import time

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def read_image(path: str):
    """A BGR u8 image from ``path``, or None where it is not one."""
    try:
        import cv2
    except ImportError:
        raise SystemExit(
            "--data reads images with cv2, which is not installed here; "
            "replace tools.train_arcface.read_image or use --synthetic")
    return cv2.imread(path)


def resize_112(img: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.resize(img, (112, 112), interpolation=cv2.INTER_LINEAR)


def count_classes(root: str) -> int:
    return len([d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d))])


def iter_dataset_batches(root: str, batch: int, seed: int):
    """(images (B, 3, 112, 112) f32 normalized, labels (B,) int64) batches
    from an identity-folder dataset; a partial last batch is dropped."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise SystemExit(f"no identity folders under {root}")
    samples = []
    for li, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for f in sorted(os.listdir(cdir)):
            if f.lower().endswith(IMAGE_EXTS):
                samples.append((os.path.join(cdir, f), li))
    order = np.random.default_rng(seed).permutation(len(samples))
    imgs, labels = [], []
    for i in order:
        path, li = samples[i]
        img = read_image(path)
        if img is None:
            continue
        if img.shape[:2] != (112, 112):
            img = resize_112(img)
        imgs.append((img.astype(np.float32) - 127.5) / 127.5)
        labels.append(li)
        if len(imgs) == batch:
            yield (np.stack(imgs).transpose(0, 3, 1, 2),
                   np.asarray(labels, np.int64))
            imgs, labels = [], []


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train an ArcFace embedder")
    ap.add_argument("--data", type=str, default=None,
                    help="identity-folder dataset root (<root>/<id>/*.jpg)")
    ap.add_argument("--variant", type=str, default="w600k_mbf",
                    choices=["w600k_mbf", "w600k_r50"])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--margin", type=float, default=0.5)
    ap.add_argument("--scale", type=float, default=64.0)
    ap.add_argument("--sample-rate", type=float, default=1.0,
                    help="Partial FC class-sampling rate (1.0 = full softmax)")
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--decay-steps", type=int, default=None,
                    help="anneal the lr to 0 over this many steps after "
                         "the warmup")
    ap.add_argument("--lr-decay", type=str, default="poly",
                    choices=["poly", "cosine"])
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block's activations in the "
                         "backward pass (less device memory)")
    ap.add_argument("--out", type=str, default="arcface_ckpt")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="train on N synthetic batches instead of a dataset")
    ap.add_argument("--num-classes", type=int, default=64,
                    help="class count for --synthetic")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="'model' mesh-axis size for the class matrix; "
                         "slots / model-shards becomes the 'data' axis")
    ap.add_argument("--slots", type=int, default=None,
                    help="mesh over N slots that share --device (default: "
                         "one a card for cuda, one for any other device)")
    args = ap.parse_args(argv)
    if not args.synthetic and not args.data:
        ap.error("--data or --synthetic required")
    return args


def training_mesh(device: str, slots, model_shards: int = 1,
                  axis_names=("data", "model")):
    """The tools' mesh: (data, model_shards) over ``parallel.
    training_slots(device, slots)``, or None for one slot (the one-device
    trainer); raises SystemExit when ``model_shards`` does not divide the
    slots."""
    from ..parallel import make_mesh, training_slots

    found = training_slots(device, slots)
    tp = max(1, model_shards)
    if len(found) % tp:
        raise SystemExit(f"--model-shards {tp} does not divide the "
                         f"{len(found)} slots")
    if len(found) == 1:
        return None
    sizes = (len(found) // tp, tp)[:len(axis_names)]
    return make_mesh(sizes, axis_names, devices=found)


def main(argv=None) -> str:
    """Train as the arguments say; returns the checkpoint's path."""
    args = parse_args(argv)
    import torch

    from ..models.arcface import build_arcface
    from ..train import ArcFaceTrainer

    if args.data and not args.synthetic:
        read_image(os.devnull)          # no reader: fail before any work
        num_classes = count_classes(args.data)
    else:
        num_classes = args.num_classes
    model = build_arcface(args.variant)
    mesh = training_mesh(args.device, args.slots, args.model_shards)
    trainer = ArcFaceTrainer(model=model, num_classes=num_classes,
                             emb_dim=model.config.emb_dim,
                             margin=args.margin, scale=args.scale,
                             learning_rate=args.lr,
                             sample_rate=args.sample_rate,
                             warmup_steps=args.warmup_steps,
                             decay_steps=args.decay_steps,
                             lr_decay=args.lr_decay, remat=args.remat,
                             device=None if mesh else args.device,
                             mesh=mesh)
    state = trainer.init_state(0)
    layout = ("" if mesh is None else " mesh=" + "x".join(
        f"{k}:{v}" for k, v in mesh.shape.items()))
    print(f"device={trainer.device}{layout} variant={args.variant} "
          f"classes={num_classes} sample={trainer.num_sample}"
          f"{'' if args.sample_rate >= 1 else ' (partial FC)'}", flush=True)
    t0 = time.time()

    def run(images, labels):
        nonlocal state
        state, loss = trainer.train_step(state, torch.from_numpy(images),
                                         torch.from_numpy(labels))
        if state.step % args.log_every == 0 or state.step == 1:
            print(f"step {state.step:6d}  loss {float(loss):8.4f}  "
                  f"{time.time() - t0:.1f}s", flush=True)

    if args.synthetic:
        rng = np.random.default_rng(0)
        for _ in range(args.synthetic):
            images = rng.normal(size=(args.batch, 112, 112, 3)
                                ).astype(np.float32)
            labels = rng.integers(0, num_classes, size=args.batch)
            run(np.ascontiguousarray(images.transpose(0, 3, 1, 2)), labels)
    else:
        for epoch in range(args.epochs):
            for images, labels in iter_dataset_batches(
                    args.data, args.batch, seed=epoch):
                run(np.ascontiguousarray(images), labels)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"step_{state.step}.pt")
    trainer.save_checkpoint(state, path)
    print(f"saved {path}")
    return path


if __name__ == "__main__":
    main()
