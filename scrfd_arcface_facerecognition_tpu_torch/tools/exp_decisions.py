"""Decision quality end to end: does the system re-identify people?

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.exp_decisions \
        all|train|eval [--det-steps 1500] [--emb-steps 1500] [--per-id 16] \
        [--seed 0] [--visits-per-id 6] [--entry json|file] \
        [--sweep-thresholds T ...] [--cache-dir DIR | --synthetic N] \
        [--ckpt-dir DIR] [--out-dir DIR] [--workdir DIR] [--device cpu]

Port of the JAX repository's ``tools/exp_decisions.py``, the repository's
one proof of decision quality:

1. identities are square person crops, one a JPEG of an image cache
   (``load_sources``), or ``synthetic_crops`` drawn from a seed;
2. det_500m trains on composites: augmented crops pasted at known
   positions onto textured backgrounds, so the box and the 5 landmarks are
   exact by construction (``train_detector``);
3. w600k_mbf trains with ArcFace on 112 x 112 crops aligned by the trained
   detector (identity = source crop), the state kept by its verification
   accuracy on identities it never trains on (``train_embedder``);
4. the whole clustering decide path (``SmartFaceEngine`` on
   ``FaceAnalysis``: gates, batched search, thresholds, SQLite and gallery
   persistence) runs over unseen identities and is scored: grouping
   precision and recall, both duplicate gates, verification through
   ``compare_face_images`` and the 0.8 merge (``run_decision_eval``).

Every face the eval decides on goes through ``FaceAnalysis`` ->
``FacePipeline``, whose crops kernel K1 (``csrc/warp_align.cu``) warps on
the card. The compositing is the JAX tool's numpy draws in the same order;
its three cv2 resizes are ``tools.host_images``' (cv2's bits without cv2,
which the card's machine lacks). Reading the cache's JPEGs still needs
cv2.

The port's differences: ``--device`` (the card unless ``cpu``) where JAX
had ``--backend``; ``--cache-dir`` (the JAX tool's ``load_sources`` takes
one, its ``main`` did not); ``--synthetic N`` identities where no cache
exists; the checkpoints it saves are ``torch.save`` files of the Flax
trees (``det_500m.pt``, ``w600k_mbf.pt``, ``meta.json``), and
``load_checkpoints`` reads those or the committed Flax msgpack files; it
writes checkpoints and ``metrics_*.json`` under ``--out-dir`` (default
``build/decisions``), never into the committed
``checkpoints/decisions/``, which it only reads (``--ckpt-dir``).
"""
from __future__ import annotations

import argparse
import copy
import glob
import json
import os
import sys
import time
from typing import Mapping, Optional

import numpy as np

from .exp_convergence import _StepClock
from .host_images import (imread, imwrite, resize_area_u8,
                          resize_linear_f32, resize_linear_u8)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# where the reference's 360 person crops go once they are in the repository
CACHE_DIR = os.path.join(_REPO_ROOT, "reference", "image_cache")
CKPT_DIR = os.path.join(_REPO_ROOT, "checkpoints", "decisions")
OUT_DIR = os.path.join(_REPO_ROOT, "build", "decisions")
SCENE = 320
# insightface's canonical 112x112 ArcFace landmark template, as fractions
# of the face box: ground-truth landmarks sit at these positions inside
# each pasted box, so a perfect detection aligns the box onto the
# canonical 112x112 frame
REL_KPS = np.array([[38.2946, 51.6963], [73.5318, 51.5014],
                    [56.0252, 71.7366], [41.5493, 92.3655],
                    [70.7299, 92.2041]], np.float32) / 112.0
N_VAL_IDS = 20    # embedder model selection (unseen during training)
N_TEST_IDS = 40   # decision eval (unseen during training AND selection)


# --------------------------------------------------------------- identities


def load_sources(cache_dir: str = CACHE_DIR, max_side: int = 288):
    """Square person crops, one per cached image (identity = file).

    Tall crops are square-cropped with a slight upward bias (heads sit in
    the upper portion); large images shrink to ``max_side`` (INTER_AREA).
    Returns (crops, names) in filename order."""
    crops, names = [], []
    for path in sorted(glob.glob(os.path.join(cache_dir, "*.jpg"))):
        img = imread(path)
        if img is None:
            continue
        h, w = img.shape[:2]
        side = min(h, w)
        y0 = min(int(0.06 * h), h - side)
        x0 = (w - side) // 2
        sq = img[y0:y0 + side, x0:x0 + side]
        if side > max_side:
            sq = resize_area_u8(sq, (max_side, max_side))
        crops.append(np.ascontiguousarray(sq))
        names.append(os.path.basename(path))
    return crops, names


def synthetic_crops(n: int, seed: int = 0, side: int = 288):
    """``n`` synthetic identities drawn from ``seed``: (crops, names).

    An identity is a square u8 BGR crop: a blocky colour field of its own
    under pixel noise, a skin-toned oval with dark eyes, nose and mouth
    drawn at the landmark template's positions. The committed det_500m,
    trained on pasted person crops, finds the pasted square in nearly
    every composite. No JAX counterpart: the card's machine has no image
    cache."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
    kps = REL_KPS * side
    cx, cy, r = side / 2, side * 0.45, side * 0.28
    oval = ((xx - cx) / r) ** 2 + ((yy - cy) / (1.25 * r)) ** 2 <= 1
    eyes = np.zeros((side, side), bool)
    for x, y in kps[:2]:
        eyes |= (xx - x) ** 2 + (yy - y) ** 2 <= (0.04 * side) ** 2
    nose = ((xx - kps[2, 0]) ** 2 + (yy - kps[2, 1]) ** 2
            <= (0.03 * side) ** 2)
    mouth = ((np.abs(xx - (kps[3, 0] + kps[4, 0]) / 2)
              <= (kps[4, 0] - kps[3, 0]) / 2)
             & (np.abs(yy - kps[3, 1]) <= 0.02 * side))
    block = -(-side // 6)
    crops, names = [], []
    for i in range(n):
        field = rng.uniform(30, 220, size=(6, 6, 3)).astype(np.float32)
        img = np.kron(field, np.ones((block, block, 1), np.float32))[
            :side, :side]
        img = img + rng.normal(scale=12, size=(side, side, 3))
        skin = rng.uniform(90, 220, size=3)
        img[oval] = skin + rng.normal(scale=6, size=(int(oval.sum()), 3))
        img[eyes] = 30
        img[nose] = skin * 0.7
        img[mouth] = 40
        crops.append(np.clip(img, 0, 255).astype(np.uint8))
        names.append(f"synthetic_{i:04d}.jpg")
    return crops, names


def split_identities(n: int, seed: int = 0):
    """Deterministic train / val / test identity split."""
    perm = np.random.default_rng(seed).permutation(n)
    test = perm[:N_TEST_IDS]
    val = perm[N_TEST_IDS:N_TEST_IDS + N_VAL_IDS]
    train = perm[N_TEST_IDS + N_VAL_IDS:]
    return train, val, test


# -------------------------------------------------------------- compositing


def augment(rng, crop: np.ndarray) -> np.ndarray:
    """Visit-to-visit appearance jitter: sub-crop, flip, photometric."""
    h, w = crop.shape[:2]
    s = rng.uniform(0.85, 1.0)
    ch, cw = int(h * s), int(w * s)
    y0 = int(rng.integers(0, h - ch + 1))
    x0 = int(rng.integers(0, w - cw + 1))
    out = crop[y0:y0 + ch, x0:x0 + cw]
    if rng.random() < 0.5:
        out = out[:, ::-1]
    a = rng.uniform(0.7, 1.3)
    b = rng.uniform(-25, 25)
    out = np.clip(out.astype(np.float32) * a + b, 0, 255).astype(np.uint8)
    if out.shape[0] != h:  # restore a stable size for the paste resize
        out = resize_linear_u8(out, (h, w))
    return np.ascontiguousarray(out)


def make_scene(rng, crop: np.ndarray, scene: int = SCENE,
               min_box: int = 112, max_box: int = 208):
    """Paste one augmented crop onto a textured background.

    Returns (scene u8 BGR, box [x1,y1,x2,y2] f32, kps (5,2) f32): exact
    ground truth by construction."""
    base = rng.uniform(50, 150)
    lowfreq = rng.normal(size=(scene // 16, scene // 16, 3)) * 22
    bg = base + resize_linear_f32(lowfreq.astype(np.float32),
                                  (scene, scene))
    bg += rng.normal(scale=7, size=(scene, scene, 3))
    img = np.clip(bg, 0, 255).astype(np.uint8)

    side = int(rng.integers(min_box, max_box + 1))
    patch = resize_area_u8(augment(rng, crop), (side, side))
    x1 = int(rng.integers(0, scene - side + 1))
    y1 = int(rng.integers(0, scene - side + 1))
    img[y1:y1 + side, x1:x1 + side] = patch
    box = np.array([x1, y1, x1 + side, y1 + side], np.float32)
    kps = REL_KPS * side + np.array([x1, y1], np.float32)
    return img, box, kps


def scene_annotation(i, box, kps):
    from ..train.detection_data import Annotation

    return Annotation(path=str(i), boxes=box[None],
                      kps=kps[None].astype(np.float32),
                      kps_valid=np.ones(1, bool))


def _first_state(trainer, seed, start, init_variables, field):
    """The trainer's starting state: ``start`` (its state parts) when
    given, else its own init from ``seed``, with the model's weights
    replaced by ``init_variables`` (a Flax-layout tree) when given."""
    from ..models.weights import state_dict_from_flax
    from ..train import state_parts

    if start is not None:
        return trainer.state_from(start)
    state = trainer.init_state(seed)
    if init_variables is None:
        return state
    parts = state_parts(state)
    parts[field] = state_dict_from_flax(init_variables)
    return trainer.state_from(parts)


# --------------------------------------------------------- detector training


def train_detector(crops, train_ids, steps, batch=16, seed=0, eval_every=250,
                   log=print, device=None, start: Optional[Mapping] = None,
                   init_variables: Optional[Mapping] = None):
    """det_500m trained on fresh composites of the training identities,
    AP@0.5 on 48 held-out scenes every ``eval_every`` steps. ``start``:
    the trainer's state parts to begin from (``SCRFDTrainer.state_from``),
    else its own init from ``seed``, from the weights ``init_variables``
    when given (a fine-tune). Returns (variables, [(step, AP)])."""
    import torch

    from ..device import resolve_device
    from ..models.scrfd import build_scrfd
    from ..models.weights import variables_from_module
    from ..pipeline import Detector
    from ..train import SCRFDLossConfig, SCRFDTrainer, evaluate_detector
    from ..train.detection_data import letterbox_example

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    trainer = SCRFDTrainer(model=build_scrfd("det_500m"),
                           loss_cfg=SCRFDLossConfig(input_size=(SCENE, SCENE)),
                           learning_rate=0.01, warmup_steps=50,
                           decay_steps=steps, device=dev)
    state = _first_state(trainer, seed, start, init_variables, "model")

    # held-out eval scenes (fresh augmentations of train identities)
    erng = np.random.default_rng(seed + 99)
    eval_imgs, eval_anns = [], []
    for i in range(48):
        img, box, kps = make_scene(erng, crops[train_ids[i % len(train_ids)]])
        eval_imgs.append(img)
        eval_anns.append(scene_annotation(i, box, kps))

    def eval_ap(variables):
        det = Detector(variant="det_500m", variables=variables,
                       input_size=(SCENE, SCENE), device=dev)
        m = evaluate_detector(det, eval_anns,
                              image_loader=lambda p: eval_imgs[int(p)])
        return m["ap"]

    def batch_arrays():
        ids = rng.choice(train_ids, size=batch)
        exs = []
        for pid in ids:
            img, box, kps = make_scene(rng, crops[pid])
            exs.append(letterbox_example((img[..., ::-1] - 127.5) / 128.0,
                                         scene_annotation(0, box, kps),
                                         (SCENE, SCENE), 2))
        return [np.stack([e[j] for e in exs]) for j in range(5)]

    curve = []
    clock = _StepClock(dev)
    for step in range(1, steps + 1):
        imgs, gtb, gtk, gtv, gkv = batch_arrays()
        x = torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous()
        state, loss, _ = clock.step(lambda: trainer.train_step(
            state, x, gtb, gtk, gtv, gkv))
        if step % eval_every == 0 or step == steps:
            ap = float(eval_ap(variables_from_module(state.model)))
            curve.append((step, ap))
            log(json.dumps({"curve": "decisions_det_ap50", "step": step,
                            "value": round(ap, 4),
                            "loss": round(float(loss), 3),
                            **clock.said()}))
    # a copy: on the CPU the tree's arrays share the module's memory
    return copy.deepcopy(variables_from_module(state.model)), curve


# --------------------------------------------------------- embedder training


def extract_aligned(det, crops, ids, per_id, seed, log=print,
                    min_iou=0.5, chunk=16):
    """Run the TRAINED detector over fresh composites and align the top
    detection to 112x112 (the pipeline's crop path: the similarity onto
    the template, the bilinear warp, ArcFace's normalize). Returns
    (net_in crops (N,112,112,3) f32 normalized, labels (N,): positions
    into ``ids``, the detection hit-rate)."""
    import torch

    from .. import ops

    def warp_batch(frames, kps):
        m = ops.estimate_norm(kps, 112)
        idx = torch.arange(frames.shape[0], dtype=torch.int32,
                           device=frames.device)
        crops112 = ops.warp_affine_flat(frames, m, idx, (112, 112))
        return ops.normalize_image(crops112, ops.ARCFACE_MEAN,
                                   ops.ARCFACE_STD)

    rng = np.random.default_rng(seed)
    scenes, labels, gt_boxes = [], [], []
    for pos, pid in enumerate(ids):
        for _ in range(per_id):
            img, box, _ = make_scene(rng, crops[pid])
            scenes.append(img)
            labels.append(pos)
            gt_boxes.append(box)

    out_crops, out_labels, hits = [], [], 0
    for c in range(0, len(scenes), chunk):
        part = np.stack(scenes[c:c + chunk])
        d = det.detect_batched(part)
        boxes = d.boxes[:, 0].cpu().numpy()
        kps = d.kps[:, 0].cpu().numpy()
        count = d.count.cpu().numpy()
        keep, keep_kps = [], []
        for bi in range(len(part)):
            if count[bi] < 1:
                continue
            gt = gt_boxes[c + bi]
            bx = boxes[bi]
            ix1, iy1 = max(gt[0], bx[0]), max(gt[1], bx[1])
            ix2, iy2 = min(gt[2], bx[2]), min(gt[3], bx[3])
            inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
            union = ((gt[2] - gt[0]) * (gt[3] - gt[1])
                     + (bx[2] - bx[0]) * (bx[3] - bx[1]) - inter)
            if union <= 0 or inter / union < min_iou:
                continue
            keep.append(bi)
            keep_kps.append(kps[bi])
            out_labels.append(labels[c + bi])
        if keep:
            net_in = warp_batch(torch.from_numpy(part[keep]).to(det.device),
                                torch.from_numpy(np.stack(keep_kps)).to(
                                    det.device))
            out_crops.append(net_in.cpu().numpy())
            hits += len(keep)
    hit_rate = hits / max(1, len(scenes))
    log(json.dumps({"stage": "extract_aligned", "scenes": len(scenes),
                    "detector_hit_rate": round(hit_rate, 4)}))
    if not out_crops:
        raise RuntimeError("detector found no faces — train it longer")
    return (np.concatenate(out_crops), np.asarray(out_labels, np.int32),
            hit_rate)


def make_pairs(crop_arr, labels, n_pairs, seed):
    """Balanced same/different verification pairs from aligned crops."""
    rng = np.random.default_rng(seed)
    by_label = {}
    for i, l in enumerate(labels):
        by_label.setdefault(int(l), []).append(i)
    usable = [l for l, v in by_label.items() if len(v) >= 2]
    pairs = []
    for _ in range(n_pairs):
        l = int(rng.choice(usable))
        i, j = rng.choice(by_label[l], size=2, replace=False)
        pairs.append((crop_arr[i], crop_arr[j], True))
        la, lb = rng.choice(usable, size=2, replace=False)
        i = int(rng.choice(by_label[int(la)]))
        j = int(rng.choice(by_label[int(lb)]))
        pairs.append((crop_arr[i], crop_arr[j], False))
    return pairs


def train_embedder(det_vars, crops, train_ids, val_ids, steps, batch=64,
                   per_id=16, seed=0, eval_every=100, log=print, device=None,
                   start: Optional[Mapping] = None,
                   init_variables: Optional[Mapping] = None):
    """ArcFace-train w600k_mbf on detector-aligned crops; keep the state
    with the best UNSEEN-identity verification accuracy (val_ids).
    ``start``: the trainer's state parts (``ArcFaceTrainer.state_from``),
    else its own init from ``seed``, the backbone from ``init_variables``
    when given. Returns (the kept variables, [(step, unseen, seen)],
    {"step", "val", "vars"})."""
    import torch

    from ..device import resolve_device
    from ..models import build_arcface
    from ..models.weights import variables_from_module
    from ..pipeline import Detector
    from ..train import ArcFaceTrainer, evaluate_embedder

    dev = resolve_device(device)
    det = Detector(variant="det_500m", variables=det_vars,
                   input_size=(SCENE, SCENE), device=dev)
    data, labels, _ = extract_aligned(det, crops, train_ids, per_id, seed,
                                      log=log)
    val_data, val_labels, _ = extract_aligned(det, crops, val_ids, 6,
                                              seed + 1, log=log)
    val_pairs = make_pairs(val_data, val_labels, 80, seed + 2)
    # seen-identity pairs: fresh scenes of training identities
    seen_data, seen_labels, _ = extract_aligned(
        det, crops, train_ids[:N_VAL_IDS], 6, seed + 3, log=log)
    seen_pairs = make_pairs(seen_data, seen_labels, 80, seed + 4)

    rng = np.random.default_rng(seed)
    trainer = ArcFaceTrainer(model=build_arcface("w600k_mbf"),
                             num_classes=len(train_ids), learning_rate=0.05,
                             warmup_steps=50, decay_steps=steps, device=dev)
    state = _first_state(trainer, seed, start, init_variables, "backbone")

    def acc(backbone, pairs):
        return float(evaluate_embedder(backbone, pairs)["accuracy"])

    def kept():
        # a copy: the trainer updates the backbone in place, and on the
        # CPU the tree's arrays share its memory
        return copy.deepcopy(variables_from_module(state.backbone))

    best = {"step": 0, "val": acc(state.backbone, val_pairs), "vars": kept()}
    curve = [(0, best["val"], acc(state.backbone, seen_pairs))]
    log(json.dumps({"curve": "decisions_verification", "step": 0,
                    "unseen_val": round(best["val"], 4),
                    "seen": round(curve[0][2], 4)}))
    clock = _StepClock(dev)
    for step in range(1, steps + 1):
        pick = rng.integers(0, len(data), size=batch)
        x = torch.from_numpy(data[pick]).permute(0, 3, 1, 2)
        y = torch.from_numpy(labels[pick].astype(np.int64))
        state, loss = clock.step(lambda: trainer.train_step(state, x, y))
        if step % eval_every == 0 or step == steps:
            va = acc(state.backbone, val_pairs)
            sa = acc(state.backbone, seen_pairs)
            curve.append((step, va, sa))
            if va > best["val"]:
                best = {"step": step, "val": va, "vars": kept()}
            log(json.dumps({"curve": "decisions_verification", "step": step,
                            "unseen_val": round(va, 4),
                            "seen": round(sa, 4),
                            "loss": round(float(loss), 3),
                            **clock.said()}))
    log(json.dumps({"stage": "model_selection", "best_step": best["step"],
                    "best_unseen_val": round(best["val"], 4)}))
    return best["vars"], curve, best


# -------------------------------------------------------------- persistence


def save_checkpoints(det_vars, emb_vars, meta, ckpt_dir=OUT_DIR):
    """The two Flax-layout trees as ``torch.save`` files of tensors
    (``det_500m.pt``, ``w600k_mbf.pt``) and ``meta.json``."""
    import torch

    from ..models.checkpoints import tensor_tree

    os.makedirs(ckpt_dir, exist_ok=True)
    for name, tree in (("det_500m", det_vars), ("w600k_mbf", emb_vars)):
        path = os.path.join(ckpt_dir, f"{name}.pt")
        torch.save(tensor_tree(tree), path + ".tmp")
        os.replace(path + ".tmp", path)
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_checkpoints(ckpt_dir=CKPT_DIR):
    """(det_vars, emb_vars, meta) from ``ckpt_dir``: the port's ``.pt``
    files where they are, else the committed Flax msgpack files."""
    from ..models.checkpoints import numpy_tree, read_checkpoint
    from ..models.weights import read_flax_msgpack

    trees = []
    for name in ("det_500m", "w600k_mbf"):
        pt = os.path.join(ckpt_dir, f"{name}.pt")
        if os.path.exists(pt):
            trees.append(numpy_tree(read_checkpoint(pt)))
            continue
        with open(os.path.join(ckpt_dir, f"{name}.msgpack"), "rb") as f:
            trees.append(read_flax_msgpack(f.read()))
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    return trees[0], trees[1], meta


def build_app(det_vars, emb_vars, det_thresh=0.5, device=None, dtype=None):
    """The facade on the two trees: det_500m at the scene's size, up to 8
    faces an image (``dtype`` None: bf16 on the card, f32 on the CPU)."""
    from ..apps.face_analysis import FaceAnalysis

    app = FaceAnalysis(det_variant="det_500m", rec_variant="w600k_mbf",
                       det_variables=det_vars, rec_variables=emb_vars,
                       max_det=8, dtype=dtype, device=device)
    app.prepare(det_size=(SCENE, SCENE), det_thresh=det_thresh)
    return app


# ----------------------------------------------------------- decision eval


def pairwise_prf(assign, truth):
    """Pairwise precision/recall/F1 of a clustering vs ground truth.

    assign/truth: {key: cluster_id}; unassigned keys count as singletons.
    """
    keys = sorted(truth)
    tp = fp = fn = 0
    for i in range(len(keys)):
        for j in range(i + 1, len(keys)):
            a, b = keys[i], keys[j]
            same_t = truth[a] == truth[b]
            sa, sb = assign.get(a), assign.get(b)
            same_a = sa is not None and sa == sb
            tp += same_t and same_a
            fp += same_a and not same_t
            fn += same_t and not same_a
    prec = tp / (tp + fp) if tp + fp else 1.0
    rec = tp / (tp + fn) if tp + fn else 1.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"precision": round(prec, 4), "recall": round(rec, 4),
            "f1": round(f1, 4), "tp": tp, "fp": fp, "fn": fn}


def run_decision_eval(det_vars, emb_vars, crops, test_ids, workdir,
                      visits_per_id=6, n_verif_pairs=40, seed=0,
                      entry="json", log=print, app=None,
                      grouping_thr=None, device=None):
    """The deliverable: the full clustering decide path on ground-truth
    data. ``app``: a facade to decide with (else ``build_app`` on the two
    trees on ``device``); the engine lives on the facade's device.
    Returns the metrics dict of the JAX tool."""
    from ..apps.clustering import SmartFaceEngine
    from ..utils.config import load_config

    if app is None:
        app = build_app(det_vars, emb_vars, device=device)

    rng = np.random.default_rng(seed + 7)
    scenes = {}
    truth = {}
    visits = []
    for pos, pid in enumerate(test_ids):
        for k in range(visits_per_id):
            img, _, _ = make_scene(rng, crops[pid])
            url = f"http://decisions/id{pos:03d}/visit{k}.jpg"
            scenes[url] = img
            truth[url] = pos
            visits.append({"id": f"v_{pos:03d}_{k}",
                           "customerId": f"cust_{pos:03d}_{k}",
                           "entryTime": "2026-08-19T12:00:00",
                           "image": url})
    # threshold-firing probes appended at the END so the genuine visits
    # cluster first:
    # (a) exact URL repeat -> the url-seen duplicate gate
    dup_url = visits[0]["image"]
    visits.append({"id": "v_dup_url", "customerId": "cust_dup_url",
                   "entryTime": "2026-08-19T12:00:01", "image": dup_url})
    # (b) same pixels under a fresh URL -> the >= 0.95 embedding duplicate
    #     gate. It must duplicate a visit that CREATES a person (the first
    #     visit, on an empty gallery): stored person embeddings are the
    #     creator's, so a later visit's pixels would score ~0.7 against
    #     its person and JOIN instead of firing the gate.
    emb_dup_url = "http://decisions/dup-pixels.jpg"
    scenes[emb_dup_url] = scenes[visits[0]["image"]]
    visits.append({"id": "v_dup_emb", "customerId": "cust_dup_emb",
                   "entryTime": "2026-08-19T12:00:02", "image": emb_dup_url})

    def loader(src, save_path=None, timeout=30):
        img = scenes.get(src)
        if img is not None and save_path:
            imwrite(save_path, img)
        return img

    os.makedirs(workdir, exist_ok=True)
    cfg = load_config("config.json")
    if grouping_thr is not None:   # threshold sweep (--sweep-thresholds)
        cfg["face_recognition"]["grouping_threshold_json"] = grouping_thr
        cfg["face_recognition"]["grouping_threshold_file"] = grouping_thr
    # the ctor consumes image_cache_dir (and mkdirs it): override BEFORE
    cfg["system"]["image_cache_dir"] = os.path.join(workdir, "cache")
    engine = SmartFaceEngine(
        database_path=os.path.join(workdir, "decisions.db"),
        app=app, image_loader=loader, config=cfg,
        results_dir=os.path.join(workdir, "results"), device=app.device)

    payload = {"visits": visits}
    t0 = time.time()
    if entry == "json":
        counters = engine.process_visit_data_from_json(payload,
                                                       save_images=False)
        grouping_thr = engine.config["face_recognition"][
            "grouping_threshold_json"]
    else:
        path = os.path.join(workdir, "visits.json")
        with open(path, "w") as f:
            json.dump(payload, f)
        counters = engine.process_visit_data(path, save_images=False)
        grouping_thr = engine.config["face_recognition"][
            "grouping_threshold_file"]
    elapsed = time.time() - t0

    # clustering assignment: url -> person_id from the persistence layer
    # (restricted to ground-truth visits: probe URLs carry no truth label)
    assign = {}
    for pid, _name in engine.db.list_persons():
        for v in engine.db.visits_for_person(pid):
            if v["image_url"] in truth:
                assign[v["image_url"]] = pid
    prf = pairwise_prf(assign, truth)
    n_ids_detected = len({truth[u] for u in assign})
    id_clusters = {}
    for u, p in assign.items():
        id_clusters.setdefault(truth[u], set()).add(p)

    # Duplicate-absorbed visits: the >= 0.95 gate skips near-identical
    # re-sightings WITHOUT recording which person they matched, so they
    # count as unassigned in the raw pairwise recall even when the skip
    # was the right call. For scoring, each absorbed visit is attributed
    # to the person whose stored embedding it matched; a skip is CORRECT
    # iff that person is the same identity. ``grouping_attributed`` is the
    # meaningful recall; the raw ``grouping`` stays reported.
    pid_truth = {}
    for u, p in assign.items():
        pid_truth.setdefault(p, []).append(truth[u])
    pid_truth = {p: max(set(v), key=v.count) for p, v in pid_truth.items()}
    attributed = dict(assign)
    n_absorbed = n_attr = n_attr_correct = 0
    for url in sorted(truth):
        if url in attributed:
            continue
        n_absorbed += 1
        faces = app.get(scenes[url])
        data, _reason = engine._gate_face(engine._best_face(faces), url)
        if data is None:
            if n_absorbed <= 3 or os.environ.get("DECISIONS_DEBUG"):
                log(json.dumps({"debug": "attr_gate_reject", "url": url,
                                "reason": _reason,
                                "n_faces": len(faces or [])}))
            continue
        hits = engine.vector_db.search_similar(data["embedding"], k=1,
                                               threshold=None)
        if not hits:
            if n_absorbed <= 3 or os.environ.get("DECISIONS_DEBUG"):
                q = np.asarray(data["embedding"], np.float32)
                log(json.dumps({
                    "debug": "attr_no_hits", "url": url,
                    "gallery_count": engine.vector_db.get_embedding_count(),
                    "qnorm": round(float(np.linalg.norm(q)), 4),
                    "q_finite": bool(np.all(np.isfinite(q))),
                    "k3": repr(engine.vector_db.search_similar(
                        q, k=3, threshold=None))[:160]}))
            continue
        attributed[url] = hits[0].id
        n_attr += 1
        n_attr_correct += pid_truth.get(hits[0].id) == truth[url]
    prf_attr = pairwise_prf(attributed, truth)

    # verification through the reference-shaped compare path
    vrng = np.random.default_rng(seed + 13)
    same_sims, diff_sims, correct = [], [], 0
    for _ in range(n_verif_pairs):
        a = int(vrng.choice(len(test_ids)))
        b = int(vrng.choice([x for x in range(len(test_ids)) if x != a]))
        s1, _, _ = make_scene(vrng, crops[test_ids[a]])
        s2, _, _ = make_scene(vrng, crops[test_ids[a]])
        d1, _, _ = make_scene(vrng, crops[test_ids[b]])
        r_same = engine.compare_face_images(s1, s2)
        r_diff = engine.compare_face_images(s1, d1)
        if r_same.get("success"):
            same_sims.append(r_same["similarity"])
            correct += bool(r_same["same_person"])
        if r_diff.get("success"):
            diff_sims.append(r_diff["similarity"])
            correct += not r_diff["same_person"]
    n_verif = len(same_sims) + len(diff_sims)
    verif = {
        "pairs": n_verif,
        "accuracy_at_0.2": round(correct / max(1, n_verif), 4),
        "same_sim_mean": round(float(np.mean(same_sims)), 4) if same_sims
        else None,
        "diff_sim_mean": round(float(np.mean(diff_sims)), 4) if diff_sims
        else None,
    }

    # merge threshold: split one test identity into two persons by hand,
    # then find_and_merge_duplicates(0.8) must reunite them, and must
    # NOT merge across identities
    mrng = np.random.default_rng(seed + 17)
    split_ids = []
    for pos in (0, 1):
        img, _, _ = make_scene(mrng, crops[test_ids[pos]])
        faces = engine.app.get(img)
        data, reason = engine._gate_face(engine._best_face(faces),
                                         f"merge-probe-{pos}")
        if data is None:
            continue
        pid = engine.add_person(f"split_probe_{pos}",
                                f"http://decisions/merge{pos}.jpg", data)
        if pid > 0:
            split_ids.append((pos, pid))
    n_persons_before = engine.db.stats()["total_persons"]
    merged, pairs = engine.find_and_merge_duplicates(return_pairs=True)
    cross_id_merges = 0
    same_id_merges = 0
    for p in pairs:
        kept_urls = [v["image_url"]
                     for v in engine.db.visits_for_person(p["kept"])]
        kept_ids = {truth[u] for u in kept_urls if u in truth}
        # merged person's identity from the probe bookkeeping
        probe = [pos for pos, pid in split_ids if pid == p["merged"]]
        if probe and kept_ids == {probe[0]}:
            same_id_merges += 1
        elif probe:
            cross_id_merges += 1
    merge = {"persons_before": n_persons_before, "merged": merged,
             "same_id_merges": same_id_merges,
             "cross_id_merges": cross_id_merges,
             "split_probes_added": len(split_ids)}

    metrics = {
        "entry": entry, "grouping_threshold": grouping_thr,
        "n_test_identities": len(test_ids),
        "n_visits": len(visits), "elapsed_s": round(elapsed, 1),
        "counters": counters,
        "grouping": prf,
        "grouping_attributed": prf_attr,
        "duplicate_attribution": {
            "absorbed": n_absorbed, "attributed": n_attr,
            "correct": n_attr_correct,
            "accuracy": round(n_attr_correct / n_attr, 4) if n_attr
            else None,
        },
        "n_identities_with_cluster": n_ids_detected,
        "mean_clusters_per_identity": round(
            float(np.mean([len(s) for s in id_clusters.values()])), 3)
        if id_clusters else None,
        "duplicate_gate": {
            "expected_min": 2,          # probes (a) + (b)
            "duplicate_faces_counter": counters["duplicate_faces"],
        },
        "verification": verif,
        "merge": merge,
    }
    log(json.dumps({"stage": "decision_eval", **metrics}))
    return metrics


# --------------------------------------------------------------------- main


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", choices=["train", "eval", "all"])
    ap.add_argument("--det-steps", type=int, default=1500)
    ap.add_argument("--emb-steps", type=int, default=1500)
    ap.add_argument("--per-id", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(OUT_DIR, "eval"),
                    help="the engine's database, cache and results")
    ap.add_argument("--visits-per-id", type=int, default=6)
    ap.add_argument("--entry", choices=["json", "file"], default="json")
    ap.add_argument("--sweep-thresholds", type=float, nargs="*",
                    default=None,
                    help="eval once per grouping threshold (one facade); "
                         "writes metrics_sweep.json instead of "
                         "metrics_<entry>.json")
    ap.add_argument("--cache-dir", default=CACHE_DIR,
                    help="the identities' JPEGs (needs cv2)")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="N synthetic identities instead of the cache")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR,
                    help="the checkpoints eval reads (default: the "
                         "committed ones)")
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="where train saves checkpoints and eval its "
                         "metrics")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.synthetic:
        crops, _names = synthetic_crops(args.synthetic, args.seed)
    else:
        crops, _names = load_sources(args.cache_dir)
    train_ids, val_ids, test_ids = split_identities(len(crops), args.seed)
    print(json.dumps({"stage": "data", "identities": len(crops),
                      "train": len(train_ids), "val": len(val_ids),
                      "test": len(test_ids)}), flush=True)

    log = lambda s: print(s, flush=True)  # noqa: E731
    os.makedirs(args.out_dir, exist_ok=True)
    if args.cmd in ("train", "all"):
        det_vars, det_curve = train_detector(
            crops, train_ids, args.det_steps, seed=args.seed, log=log,
            device=args.device)
        emb_vars, emb_curve, best = train_embedder(
            det_vars, crops, train_ids, val_ids, args.emb_steps,
            per_id=args.per_id, seed=args.seed, log=log, device=args.device)
        meta = {
            "seed": args.seed, "scene": SCENE,
            "split": {"train": len(train_ids), "val": len(val_ids),
                      "test": len(test_ids)},
            "det_steps": args.det_steps, "emb_steps": args.emb_steps,
            "det_ap_curve": det_curve,
            "emb_curve": [list(c) for c in emb_curve],
            "best_unseen_val_accuracy": best["val"],
            "best_step": best["step"],
            "trained_at": time.strftime("%Y-%m-%d %H:%M:%S"),
        }
        save_checkpoints(det_vars, emb_vars, meta, args.out_dir)
        print(json.dumps({"stage": "checkpoints_saved",
                          "dir": args.out_dir}), flush=True)
    if args.cmd in ("eval", "all"):
        if args.cmd == "eval":
            det_vars, emb_vars, _meta = load_checkpoints(args.ckpt_dir)
        if args.sweep_thresholds:
            app = build_app(det_vars, emb_vars, device=args.device)
            sweep = []
            for thr in args.sweep_thresholds:
                m = run_decision_eval(
                    det_vars, emb_vars, crops, test_ids,
                    os.path.join(args.workdir, f"thr_{thr:g}"),
                    visits_per_id=args.visits_per_id, seed=args.seed,
                    entry=args.entry, log=log, app=app, grouping_thr=thr)
                sweep.append(m)
            out = os.path.join(args.out_dir, "metrics_sweep.json")
            with open(out, "w") as f:
                json.dump(sweep, f, indent=2)
        else:
            metrics = run_decision_eval(
                det_vars, emb_vars, crops, test_ids, args.workdir,
                visits_per_id=args.visits_per_id, seed=args.seed,
                entry=args.entry, log=log, device=args.device)
            out = os.path.join(args.out_dir, f"metrics_{args.entry}.json")
            with open(out, "w") as f:
                json.dump(metrics, f, indent=2)
        print(json.dumps({"stage": "done", "metrics_file": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
