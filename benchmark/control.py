"""The controls: what the comparison must find not correct.

A stream cell's configuration computes in bfloat16, so its control is the
plain reference in the program's place one step lower: both models in fp8
(e4m3, one scale a tensor; ``reference.precision.fp8_emulated``), the
match in TF32, run over the cell's own pool of frames and judged as the
program's batches are. A lookup cell's configuration searches at "hilo"
(the exact float32 table); the program has the step below as a path of its
own, "hi" (the table in bfloat16), which serves as its control.
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import align, detect
from benchmark.reference.precision import fp8_emulated, tf32_round


def stream_outputs(det, rec, frames, rows, cfg) -> Dict[str, torch.Tensor]:
    """The reference pipeline's outputs for one batch, laid out as the
    program's (``PipelineOutput``'s fields)."""
    net_in, scale = detect.letterbox(frames, tuple(cfg["det_size"]))
    hd = detect.heads(det, net_in, scale)
    sel = detect.select(hd, conf=cfg["conf_thres"], iou=cfg["iou_thres"],
                        pre_nms=cfg["pre_nms"], max_det=cfg["max_det"],
                        max_num=cfg["max_num"])
    kept = sel["kept"]
    valid = kept >= 0
    a = kept.clamp_min(0)
    boxes = torch.gather(hd["box"], 1, a[..., None].expand(-1, -1, 4))
    kps = torch.gather(hd["kps"], 1, a[..., None, None].expand(-1, -1, 5, 2))
    scores = torch.gather(hd["score"], 1, a)
    fidx = torch.nonzero(valid)[:, 0]
    e = align.embed(rec, frames, kps[valid], fidx)
    g = torch.nn.functional.normalize(rows.float(), dim=1)
    sims = tf32_round(e) @ tf32_round(g).T
    best, idx = sims.max(1)
    b, s = valid.shape
    emb = torch.zeros((b, s, e.shape[1]), device=frames.device)
    emb[valid] = e
    m_idx = torch.full((b, s), -1, dtype=torch.int32, device=frames.device)
    m_idx[valid] = torch.where(best > cfg["similarity_thresh"], idx,
                               -1).int()
    m_sim = torch.zeros((b, s), device=frames.device)
    m_sim[valid] = best.clamp_min(0)
    z = torch.zeros_like
    return {"boxes": torch.where(valid[..., None], boxes, z(boxes)),
            "scores": torch.where(valid, scores, z(scores)),
            "kps": torch.where(valid[..., None, None], kps, z(kps)),
            "valid": valid, "count": sel["count"].int(),
            "embeddings": emb, "match_idx": m_idx, "match_sim": m_sim}


def stream_control(det_ref, rec_ref, pool, rows, cfg) -> Dict[int, Dict]:
    """The fp8 control's outputs for every batch of the pool, keyed as
    the window's batches are (batch i is pool entry i % pool)."""
    det, rec = fp8_emulated(det_ref), fp8_emulated(rec_ref)
    with torch.no_grad():
        return {p: stream_outputs(det, rec, pool[p], rows, cfg)
                for p in range(pool.shape[0])}
