"""The comparison that decides ``correct``: what the timed path produced,
judged against the plain reference (``reference/``).

Stream cells. For every valid face of a judged batch:

- ``face_gap`` (detector): each reported face against the reference's
  anchor nearest to it: the score gap, how far it lies under ``conf`` or
  the slate's cut, its overlap past the NMS threshold with another
  reported face (see ``face_gaps``); the widest over the faces.
- ``geometry_gap`` (detector): the coordinate gap of box and keypoints to
  that anchor over the span of the face's box corners and landmarks,
  averaged over the faces; a face that is no decoded anchor reads high.
- ``keep_gap`` (selection): the least bias toward the program's choices
  at which the reference's own top-K, NMS, ``max_det`` and largest-face
  selection keeps the reported faces, frame by frame (``keep_gaps``),
  averaged over the judged frames; a frame that no bias explains makes it
  infinite.
- ``emb_gap`` (embedder): 1 - cos between the face's embedding and the
  reference's embedding of the crop at the face's reported landmarks
  (which ``geometry_gap`` holds to the reference's own).
- ``match_gap`` (match): from the face's own embedding against the
  gallery in float64, the largest of: the reported similarity's gap to the
  best one; how far the reported row lies below the best; how far a
  reported row lies under the threshold, or the best one above it when no
  row is reported.
- ``slots_wrong`` (count and layout, exact): frames whose face count
  differs from the reference's, slots whose validity disagrees with the
  count, invalid slots that carry an embedding, a row or a similarity.

Lookup cells. For every answer (query, rank): the largest of the reported
score's gap to the reference score of the reported row, and how far that
row's reference score lies below the reference's score at that rank
(``lookup_gap``); a row outside the gallery, or one a query's answer
repeats, reads infinite.

A NaN reads infinite: it never passes.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

INF = float("inf")


def worst(t: torch.Tensor) -> float:
    if t.numel() == 0:
        return 0.0
    return float(torch.nan_to_num(t.double(), nan=INF).max())


def mean(t: torch.Tensor) -> float:
    """The mean; infinite where any value is infinite or NaN."""
    if t.numel() == 0:
        return 0.0
    return float(torch.nan_to_num(t.double(), nan=INF).mean())


FACE_PARTS = ("geometry", "score", "under", "overlap")
# the biases at which ``keep_gaps`` asks the reference for a kept set: 0,
# then from 1e-4 to 1 in steps of a tenth of a decade
BANDS = (0.0,) + tuple(float(f"{10 ** (i / 10):.3g}") for i in range(-40, 1))


def nearest_anchors(out: Dict[str, torch.Tensor],
                    ref: Dict[str, torch.Tensor], block: int = 16):
    """(B, S) the reference anchor nearest each reported face by the
    largest coordinate gap of box and keypoints (-1 for an empty slot),
    and (B, S) that gap."""
    anchors = torch.cat([ref["box"], ref["kps"].flatten(2)], 2)   # (B, N, 14)
    coords = torch.cat([out["boxes"].float(), out["kps"].float().flatten(2)],
                       2)                                         # (B, S, 14)
    dist, a = [], []
    for f in range(0, coords.shape[0], block):
        d = (coords[f:f + block, :, None]
             - anchors[f:f + block, None]).abs().amax(3)          # (b, S, N)
        m = torch.nan_to_num(d, nan=INF).min(2)
        dist.append(m.values)
        a.append(m.indices)
    return torch.where(out["valid"], torch.cat(a), -1), torch.cat(dist)


def face_gaps(out: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              picked: torch.Tensor, dist: torch.Tensor, conf: float,
              iou: float) -> Dict[str, torch.Tensor]:
    """The detector gaps of one batch's reported faces by part
    (``FACE_PARTS``); a face's gap is the largest of its parts. ``out``:
    boxes (B, S, 4), scores (B, S), kps (B, S, 5, 2), valid (B, S);
    ``ref``: every anchor's score (B, N), box (B, N, 4), kps (B, N, 5, 2)
    in frame pixels and the slate's cut (B,); ``picked``, ``dist`` from
    ``nearest_anchors``.

    Each face is held to its nearest anchor: the coordinate gap over the
    span of the face's box corners and landmarks (geometry), the score's gap to the anchor's reference
    score (score), how far that score lies below ``conf`` or the reference
    slate's cut (under), and how far the face's overlap with another
    reported face exceeds ``iou`` (overlap). Which faces are kept is
    ``keep_gaps``'."""
    from benchmark.reference.detect import iou_plus1

    v = out["valid"]
    a = picked.clamp_min(0)
    # the face's extent: the span of its box corners and landmarks (a
    # landmark errs by a share of its offset, which may reach past a small
    # box)
    points = torch.cat([out["boxes"].float().unflatten(-1, (2, 2)),
                        out["kps"].float()], -2)                  # (B, S, 7, 2)
    extent = (points.amax(-2) - points.amin(-2)).amax(-1).clamp_min(1.0)
    rs = torch.gather(ref["score"], 1, a)
    rb = torch.gather(ref["box"], 1, a[..., None].expand(-1, -1, 4))
    over = iou_plus1(rb, rb) - iou
    both = v[:, :, None] & v[:, None, :]
    over = torch.where(both & ~torch.eye(v.shape[1], dtype=torch.bool,
                                         device=v.device), over, 0.0)
    gaps = {"geometry": dist / extent,
            "score": (out["scores"].float() - rs).abs(),
            "under": torch.maximum(ref["cut"][:, None] - rs,
                                   conf - rs).clamp_min(0),
            "overlap": over.clamp_min(0).amax(2)}
    return {k: g[v] for k, g in gaps.items()}


def keep_gaps(ref: Dict[str, torch.Tensor], picked: torch.Tensor,
              cfg: dict) -> torch.Tensor:
    """(B,) for each frame, the least bias (``BANDS``) at which the
    reference's own selection keeps exactly the anchors the program
    reported (``picked``); infinite where none does (a count that differs,
    an anchor reported twice).

    The stand-ins' scores lie within thousandths of each other, so
    rounding reorders the slate, NMS and the largest-face choice, and a
    sound run keeps other faces than the reference does. Each such choice
    is a near tie, which a small bias toward the program's choice
    reproduces; a selection that departs from the rule needs a large one.
    The bias favours the reported anchors (tier 1), then the anchors
    smaller than the smallest reported face, which the program may have
    kept and then left out as too small (tier 0), against the rest (tier
    -1): see ``reference.detect.select``."""
    from benchmark.reference.detect import select

    b = ref["score"].shape[0]
    box = ref["box"]
    area = (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])
    valid = picked >= 0
    a = picked.clamp_min(0)
    smallest = torch.where(valid, torch.gather(area, 1, a),
                           INF).amin(1, keepdim=True)
    reported = torch.zeros_like(area, dtype=torch.int32).scatter_add(
        1, a, valid.int()) > 0
    tier = torch.where(reported, 1, torch.where(area < smallest, 0, -1))
    want = torch.sort(picked, 1).values
    need = torch.full((b,), INF, dtype=torch.float64, device=picked.device)
    for band in BANDS:
        todo = torch.nonzero(torch.isinf(need))[:, 0]
        if not len(todo):
            break
        got = select({k: ref[k][todo] for k in ("score", "box")},
                     conf=cfg["conf_thres"], iou=cfg["iou_thres"],
                     pre_nms=cfg["pre_nms"], max_det=cfg["max_det"],
                     max_num=cfg["max_num"], tier=tier[todo], band=band)
        same = (torch.sort(got["kept"], 1).values == want[todo]).all(1)
        need[todo[same]] = band
    return need


def slots_wrong(out: Dict[str, torch.Tensor], ref_count: torch.Tensor) -> int:
    """Frames whose face count differs from the reference's, and slots
    laid out against the counts: the first ``count`` of a frame valid and
    no other, invalid slots with no embedding, row or similarity."""
    valid = out["valid"]
    count = out["count"].long()
    s = valid.shape[1]
    want_valid = torch.arange(s, device=valid.device)[None] < count[:, None]
    bad = int((count != ref_count.to(count.device)).sum())
    bad += int((valid != want_valid).sum())
    inv = ~valid
    bad += int(((out["embeddings"][inv] != 0).any(-1)).sum())
    bad += int((out["match_idx"][inv] != -1).sum())
    bad += int((out["match_sim"][inv] != 0).sum())
    return bad


def emb_gaps(emb: torch.Tensor, ref_emb: torch.Tensor) -> torch.Tensor:
    cos = (torch.nn.functional.normalize(ref_emb.double(), dim=1)
           * emb.double()).sum(1)
    norm_off = (emb.double().norm(dim=1) - 1).abs()
    return torch.maximum(1 - cos, norm_off)


def match_gaps(emb: torch.Tensor, idx: torch.Tensor, sim: torch.Tensor,
               gallery: torch.Tensor, thresh: float) -> torch.Tensor:
    """(F,) gaps of F valid faces' reported rows and similarities."""
    g = torch.nn.functional.normalize(gallery.double(), dim=1)
    sims = emb.double() @ g.T                                 # (F, G)
    best = sims.max(1).values
    idx = idx.long()
    picked = sims.gather(1, idx.clamp_min(0)[:, None])[:, 0]
    some = idx >= 0
    gap = (sim.double() - best.clamp_min(0)).abs()
    gap = torch.maximum(gap, torch.where(
        some, torch.maximum(best - picked, thresh - picked),
        best - thresh).clamp_min(0))
    out_of_range = (idx >= gallery.shape[0]) | (idx < -1)
    return torch.where(out_of_range, torch.full_like(gap, INF), gap)


def lookup_gaps(scores: torch.Tensor, rows: torch.Tensor,
                ref_at: torch.Tensor, ref_top: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """(Q, k) gaps of reported scores and rows: ``ref_at`` the reference
    score at each reported row, ``ref_top`` the reference's k best. A row
    outside the gallery, or one a query's answer repeats, reads
    infinite."""
    gap = torch.maximum((scores.double() - ref_at).abs(),
                        (ref_top - ref_at).clamp_min(0))
    srt, order = rows.sort(dim=1)
    again = torch.zeros_like(rows, dtype=torch.bool)
    again[:, 1:] = srt[:, 1:] == srt[:, :-1]
    repeated = torch.zeros_like(again).scatter_(1, order, again)
    bad = (rows < 0) | (rows >= n_rows) | repeated
    return torch.where(bad, torch.full_like(gap, INF), gap)


def check(name: str, value: float, limit: float) -> Dict:
    if not math.isfinite(value):
        value = INF
    return {"name": name, "value": value, "limit": limit}
