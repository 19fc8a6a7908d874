"""Both trainers memorize a synthetic set, scored through the full eval
paths, on the card.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.exp_convergence \
        [--arc-steps 300] [--det-steps 400] [--only arc|det|both] \
        [--device cpu]

Port of the JAX repository's ``tools/exp_convergence.py``. One falling loss
shows that the gradients flow; these curves show that the models learn:

- ArcFace (w600k_mbf over 50 synthetic identities: a low-frequency base
  pattern an identity, shifted and heavily noised): verification accuracy
  on 200 held-out pairs (``train.evaluate_embedder``) climbs from chance
  toward 1.0 as the embedder memorizes the identities;
- SCRFD (det_500m on a fixed set of 16 synthetic images: face-shaped
  patterns on textured backgrounds): AP@0.5 on the training images,
  scored through the whole inference path (``pipeline.Detector``:
  letterbox, forward, decode, NMS; ``train.evaluate_detector``), climbs
  from 0 as the detector overfits.

The data are the JAX tool's numpy draws, in the same order. Prints the JAX
tool's JSON line a curve point (``curve``, ``step``, ``value``, then
``loss`` and ``elapsed_s``), each with ``ms_step``: the mean ms of the
training steps so far, the card synchronized around each. Runs on the
card unless given ``--device cpu``. The JAX tool's ``--backend`` (JAX's
platform) is ``--device`` here.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Mapping, Optional

import numpy as np

from . import synchronize

# ------------------------------------------------------------------ arcface


def identity_image(base, rng, shift=4, noise=2.5):
    """One 112x112 sample of an identity: its base pattern, randomly
    shifted a few pixels and heavily noised (normalized-space images).

    At noise 2.5 (2.5x the base pattern's own std) a random-init embedder
    scores near chance on the verification pairs, so the curve's rise is
    the training's."""
    dx, dy = rng.integers(-shift, shift + 1, size=2)
    img = np.roll(base, (int(dy), int(dx)), axis=(0, 1))
    return img + noise * rng.normal(size=img.shape).astype(np.float32)


def make_identity_bases(rng, n_ident):
    """Low-frequency per-identity patterns (14x14 random field x8)."""
    small = rng.normal(size=(n_ident, 14, 14, 3)).astype(np.float32)
    return np.repeat(np.repeat(small, 8, axis=1), 8, axis=2)


def verification_pairs(bases, rng, n=100):
    """``n`` same-identity and ``n`` different-identity pairs of fresh
    jitters (held out: the trainer never sees them), as (a, b, same)."""
    pairs = []
    for _ in range(n):
        a, b = rng.choice(len(bases), size=2, replace=False)
        pairs.append((identity_image(bases[a], rng),
                      identity_image(bases[a], rng), True))
        pairs.append((identity_image(bases[a], rng),
                      identity_image(bases[b], rng), False))
    return pairs


def _emitter(emit):
    return emit or (lambda line: print(json.dumps(line), flush=True))


class _StepClock:
    """Seconds inside the training steps, the device synchronized around
    each, and seconds since the loop began."""

    def __init__(self, dev):
        self.dev, self.train_s, self.steps = dev, 0.0, 0
        self.t0 = time.time()

    def step(self, fn):
        synchronize(self.dev)
        t = time.perf_counter()
        out = fn()
        synchronize(self.dev)
        self.train_s += time.perf_counter() - t
        self.steps += 1
        return out

    def ms_step(self):
        return 1e3 * self.train_s / max(self.steps, 1)

    def said(self):
        return {"elapsed_s": round(time.time() - self.t0, 1),
                "ms_step": round(self.ms_step(), 3)}


def run_arcface(steps: int, eval_every: int, batch: int, n_ident: int = 50,
                seed: int = 0, device=None,
                start: Optional[Mapping] = None,
                emit: Callable[[dict], None] = None) -> dict:
    """The ArcFace curve. ``start``: the trainer's state parts to begin
    from (``ArcFaceTrainer.state_from``), else its own init from ``seed``.
    Returns {"curve": [(step, accuracy)], "losses": every step's loss,
    "ms_step", "elapsed_s"}."""
    import torch

    from ..device import resolve_device
    from ..models import build_arcface
    from ..train import ArcFaceTrainer, evaluate_embedder

    emit = _emitter(emit)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    bases = make_identity_bases(rng, n_ident)
    trainer = ArcFaceTrainer(model=build_arcface("w600k_mbf"),
                             num_classes=n_ident, learning_rate=0.05,
                             warmup_steps=20, decay_steps=steps, device=dev)
    state = (trainer.init_state(seed) if start is None
             else trainer.state_from(start))
    pairs = verification_pairs(bases, np.random.default_rng(seed + 1))

    def accuracy():
        return float(evaluate_embedder(state.backbone, pairs)["accuracy"])

    curve = [(0, accuracy())]
    emit({"curve": "arcface_verification_accuracy", "step": 0,
          "value": curve[0][1]})
    clock, losses = _StepClock(dev), []
    for step in range(1, steps + 1):
        ids = rng.integers(0, n_ident, size=batch)
        images = np.stack([identity_image(bases[i], rng) for i in ids])
        x = torch.from_numpy(images).permute(0, 3, 1, 2)
        state, loss = clock.step(lambda: trainer.train_step(
            state, x, torch.from_numpy(ids.astype(np.int64))))
        losses.append(float(loss))
        if step % eval_every == 0 or step == steps:
            acc = accuracy()
            curve.append((step, acc))
            emit({"curve": "arcface_verification_accuracy", "step": step,
                  "value": round(acc, 4), "loss": round(losses[-1], 3),
                  **clock.said()})
    return {"curve": curve, "losses": losses, "ms_step": clock.ms_step(),
            "elapsed_s": time.time() - clock.t0}


# -------------------------------------------------------------------- scrfd


def paint_face(img, x1, y1, side):
    """A face-shaped pattern: bright oval + dark eyes + mouth."""
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx, cy, r = x1 + side / 2, y1 + side / 2, side / 2
    oval = ((xx - cx) / r) ** 2 + ((yy - cy) / (1.1 * r)) ** 2 <= 1.0
    img[oval] = 215
    for ex in (x1 + 0.3 * side, x1 + 0.7 * side):
        eye = ((xx - ex) ** 2 + (yy - (y1 + 0.4 * side)) ** 2
               <= (0.08 * side) ** 2)
        img[eye] = 30
    mouth = ((np.abs(xx - cx) <= 0.22 * side)
             & (np.abs(yy - (y1 + 0.78 * side)) <= 0.05 * side))
    img[mouth] = 50


def make_detection_set(rng, n_images=16, size=320, max_faces=3):
    """(images (size, size, 3) uint8, their ``Annotation``s): 1 to
    ``max_faces`` painted faces an image on a textured background, every
    landmark labelled."""
    from ..train.detection_data import Annotation

    images, anns = [], []
    rel = np.asarray([[0.3, 0.4], [0.7, 0.4], [0.5, 0.6],
                      [0.35, 0.8], [0.65, 0.8]], np.float32)
    for i in range(n_images):
        img = (rng.uniform(60, 120) * np.ones((size, size, 3))
               + rng.normal(scale=8, size=(size, size, 3))).clip(0, 255)
        n = int(rng.integers(1, max_faces + 1))
        boxes, kps = [], []
        for _ in range(n):
            side = float(rng.uniform(48, 120))
            x1 = float(rng.uniform(0, size - side))
            y1 = float(rng.uniform(0, size - side))
            paint_face(img, x1, y1, side)
            boxes.append([x1, y1, x1 + side, y1 + side])
            kps.append(np.stack([x1 + rel[:, 0] * side,
                                 y1 + rel[:, 1] * side], axis=1))
        images.append(img.astype(np.uint8))
        anns.append(Annotation(
            path=str(i), boxes=np.asarray(boxes, np.float32),
            kps=np.asarray(kps, np.float32),
            kps_valid=np.ones(len(boxes), bool)))
    return images, anns


def run_scrfd(steps: int, eval_every: int, batch: int, seed: int = 0,
              size: int = 320, device=None,
              start: Optional[Mapping] = None,
              emit: Callable[[dict], None] = None) -> dict:
    """The SCRFD curve. ``start``: the trainer's state parts to begin from
    (``SCRFDTrainer.state_from``), else its own init from ``seed``.
    Returns {"curve": [(step, AP@0.5)], "losses", "ms_step",
    "elapsed_s"}."""
    import torch

    from ..device import resolve_device
    from ..models.scrfd import build_scrfd
    from ..models.weights import variables_from_module
    from ..pipeline import Detector
    from ..train import SCRFDLossConfig, SCRFDTrainer, evaluate_detector
    from ..train.detection_data import letterbox_example

    emit = _emitter(emit)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    images, anns = make_detection_set(rng, size=size)
    trainer = SCRFDTrainer(model=build_scrfd("det_500m"),
                           loss_cfg=SCRFDLossConfig(input_size=(size, size)),
                           learning_rate=0.01, warmup_steps=20,
                           decay_steps=steps, device=dev)
    state = (trainer.init_state(seed) if start is None
             else trainer.state_from(start))

    # pre-letterboxed training tensors (a fixed set: the overfit target)
    max_gt = 4
    exs = [letterbox_example((img[..., ::-1] - 127.5) / 128.0, ann,
                             (size, size), max_gt)
           for img, ann in zip(images, anns)]

    def eval_ap():
        det = Detector(variant="det_500m",
                       variables=variables_from_module(state.model),
                       input_size=(size, size), device=dev)
        m = evaluate_detector(det, anns, image_loader=lambda p: images[int(p)])
        return float(m["ap"])

    curve = [(0, eval_ap())]
    emit({"curve": "scrfd_ap50", "step": 0, "value": round(curve[0][1], 4)})
    clock, losses = _StepClock(dev), []
    for step in range(1, steps + 1):
        pick = rng.integers(0, len(exs), size=batch)
        imgs, gtb, gtk, gtv, gkv = (np.stack([exs[i][j] for i in pick])
                                    for j in range(5))
        x = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous()
        state, loss, _ = clock.step(lambda: trainer.train_step(
            state, x, gtb, gtk, gtv, gkv))
        losses.append(float(loss))
        if step % eval_every == 0 or step == steps:
            ap = eval_ap()
            curve.append((step, ap))
            emit({"curve": "scrfd_ap50", "step": step, "value": round(ap, 4),
                  "loss": round(losses[-1], 3), **clock.said()})
    return {"curve": curve, "losses": losses, "ms_step": clock.ms_step(),
            "elapsed_s": time.time() - clock.t0}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arc-steps", type=int, default=300)
    ap.add_argument("--det-steps", type=int, default=400)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--only", choices=["arc", "det", "both"], default="both")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.only in ("arc", "both"):
        run_arcface(args.arc_steps, args.eval_every, args.batch,
                    device=args.device)
    if args.only in ("det", "both"):
        run_scrfd(args.det_steps, args.eval_every, max(8, args.batch // 4),
                  device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
