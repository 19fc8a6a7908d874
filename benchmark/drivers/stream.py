"""Driver of the stream mixes (``"kind": "stream"``): batches of frames
through ``FacePipeline.process_stream``, closed loop.

Set-up, all from the run's seed: a pool of distinct frame batches drawn
on the card; the configuration's reference modules with their weights
drawn on the card and their BatchNorm statistics calibrated on the pool's
first frames (``reference_models``), handed to the program through ONNX
files and the port's importer (``config_from_graph.variables_from_onnx``,
the production load path); the gallery (rows near the embeddings of the
calibration's faces, then random rows). The pool is kept on the card
(``"feed": "card"``) or copied once to host memory (``"feed": "host"``,
numpy batches the pipeline stages through its pinned ring). Every batch
of the pool goes through the stream twice before the window.

The window: ``process_stream(depth)`` pulls the pool's batches in turn
until ``seconds`` have passed, then drains; the card is synchronised at
both ends. A batch's latency runs from the stream taking it from the
iterator to its output being yielded (host clock). A share of the
batches, drawn from the seed, keeps its outputs for the comparison.

Traced runs add CUDA events around the pipeline's stages for the whole
window (the port's stage hook), then a profiled slice of the same traffic.
"""
from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from benchmark import compare, core, counts, trace
from benchmark.reference import align, detect, standins

# the numbers compared, in the order they are printed
CHECKS = ("face_gap", "geometry_gap", "keep_gap", "emb_gap", "match_gap",
          "slots_wrong")
FIELDS = ("boxes", "scores", "kps", "valid", "count", "embeddings",
          "match_idx", "match_sim")


class StageClock:
    """Stage hook: CUDA events around every stage of the pipeline (the
    repository's ``chip_smoke.StageTimer``); on the CPU, where the tests
    rehearse a run, the host clock."""

    def __init__(self, torch, device):
        self.torch = torch
        self.card = device.type == "cuda"
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name):
        if self.card:
            s = self.torch.cuda.Event(enable_timing=True)
            e = self.torch.cuda.Event(enable_timing=True)
            s.record()
        else:
            s = time.perf_counter()
        try:
            yield
        finally:
            if self.card:
                e.record()
            else:
                e = time.perf_counter()
            self.events.append((name, s, e))

    def totals_ms(self) -> Dict[str, float]:
        if self.card:
            self.torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for name, s, e in self.events:
            ms = s.elapsed_time(e) if self.card else (e - s) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out


def seeds(seed: int) -> Dict[str, int]:
    return {t: core.sub_seed(seed, t)
            for t in ("det", "rec", "frames", "gallery", "judge")}


def reference_models(cfg: dict, traffic: dict, sd: Dict[str, int], pool,
                     device):
    """The configuration's reference modules, their weights drawn from the
    seed on the card and their BatchNorm statistics calibrated on the
    first ``calib_frames`` frames of the pool's first batch: the
    detector's on those frames letterboxed, then the embedder's on the
    crops of the faces the calibrated detector keeps there. Returns the
    two modules and those faces' unit embeddings."""
    import torch

    from benchmark.reference.precision import f32_exact

    with f32_exact(), torch.no_grad():
        det = standins.build(cfg["detector"], sd["det"], device)
        rec = standins.build(cfg["embedder"], sd["rec"], device)
        frames = pool[0][:traffic["calib_frames"]]
        net_in, _ = detect.letterbox(frames, tuple(cfg["det_size"]))
        standins.calibrate_norms_(det, net_in)
        del net_in
        ref = reference_detections(det, frames, cfg)
        valid = ref["kept"] >= 0
        fidx = torch.nonzero(valid)[:, 0]
        kps = ref["kps"][fidx, ref["kept"][valid]]
        crops = align.net_input(frames, kps, fidx)
        standins.calibrate_norms_(rec, crops)
        faces = torch.nn.functional.normalize(rec(crops), dim=1)
    return det, rec, faces


def program(cfg: dict, traffic: dict, det_ref, rec_ref, device):
    """The port's FacePipeline on the reference's weights, loaded through
    ONNX files and the port's importer, at the configured compute
    dtype."""
    import torch

    from scrfd_arcface_facerecognition_tpu_torch import FacePipeline
    from scrfd_arcface_facerecognition_tpu_torch.models.config_from_graph \
        import variables_from_onnx
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
        Detector, Embedder)

    side = tuple(cfg["det_size"])
    with tempfile.TemporaryDirectory() as tmp:
        det_path, rec_path = Path(tmp, "det.onnx"), Path(tmp, "rec.onnx")
        standins.export_onnx(det_ref, torch.zeros((1, 3, *side),
                                                  device=device),
                             str(det_path))
        standins.export_onnx(rec_ref, torch.zeros((1, 3, 112, 112),
                                                  device=device),
                             str(rec_path))
        det_cfg, det_v = variables_from_onnx(
            str(det_path), name=cfg["detector"]["variant"], input_size=side)
        rec_cfg, rec_v = variables_from_onnx(
            str(rec_path), name=cfg["embedder"]["variant"])
    dtype = getattr(torch, cfg["compute_dtype"])
    det = Detector(config=det_cfg, variables=det_v, input_size=side,
                   conf_thres=cfg["conf_thres"], iou_thres=cfg["iou_thres"],
                   pre_nms=cfg["pre_nms"], max_det=cfg["max_det"],
                   dtype=dtype, device=device)
    emb = Embedder(config=rec_cfg, variables=rec_v, dtype=dtype,
                   device=device)
    return FacePipeline(detector=det, embedder=emb,
                        gallery_capacity=traffic["gallery_rows"],
                        similarity_thresh=cfg["similarity_thresh"],
                        device=device)


def gallery_rows(traffic: dict, faces, seed: int, device):
    """(G, D) float32: ``gallery_near`` rows around the embeddings of the
    calibration's faces (``faces``, in turn) at growing distance, then
    random rows: the faces of the first frames are enrolled, at
    similarities from about 1 down past the threshold."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    d = faces.shape[1]
    near = traffic["gallery_near"]
    noise = torch.randn((traffic["gallery_rows"], d), generator=gen,
                        device=device) / d ** 0.5
    sigma = torch.linspace(0.05, 3.0, near, device=device)
    rows = noise.clone()
    rows[:near] = (faces[torch.arange(near, device=device) % len(faces)]
                   + sigma[:, None] * noise[:near])
    return rows.float()


def frame_pool(traffic: dict, seed: int, device):
    """(pool, B, H, W, 3) u8 BGR frames drawn on the card."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (traffic["pool"], traffic["frames"], traffic["height"],
             traffic["width"], 3)
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                         device=device)


def window(pipe, batches: List, seconds: float, depth: int, max_num: int,
           keep: np.ndarray, sync, count_faces: bool = False) -> Dict:
    """Closed loop over ``batches`` in turn for ``seconds``: the frames
    yielded, the window's seconds (card synchronised at both ends), each
    batch's latency, the kept outputs {batch index: output}, and with
    ``count_faces`` the faces reported (summed on the device)."""
    taken: List[float] = []
    latency: List[float] = []
    kept: Dict[int, object] = {}
    faces = None

    def feed(deadline):
        i = 0
        while time.perf_counter() < deadline:
            taken.append(time.perf_counter())
            yield batches[i % len(batches)]
            i += 1

    sync()
    t0 = time.perf_counter()
    frames, i, out = 0, -1, None
    for i, out in enumerate(pipe.process_stream(feed(t0 + seconds),
                                                max_num=max_num,
                                                depth=depth)):
        latency.append(time.perf_counter() - taken[i])
        frames += out.boxes.shape[0]
        if count_faces:
            n = out.count.sum()
            faces = n if faces is None else faces + n
        if i < len(keep) and keep[i]:
            kept[i] = out
    sync()
    if out is not None:
        kept[i] = out                   # the drain's last batch, always
    return {"frames": frames, "seconds": time.perf_counter() - t0,
            "latency": latency, "kept": kept,
            "faces": None if faces is None else int(faces)}


def judge_batches(torch, cfg, pool, kept, rows, det_ref, rec_ref,
                  device) -> Dict:
    """The comparison of every kept batch with the reference: the worst
    of each number over them."""
    from benchmark.reference.precision import f32_exact

    n_pool = pool.shape[0]
    with f32_exact(), torch.no_grad():
        refs, embs = {}, {}
        gaps = {"keep_gap": [], "emb_gap": [], "match_gap": []}
        parts = {k: [] for k in compare.FACE_PARTS}
        wrong = 0
        gallery = rows.to(device)
        for i, out in sorted(kept.items()):
            p = i % n_pool
            frames = pool[p]
            if p not in refs:
                refs[p] = reference_detections(det_ref, frames, cfg)
            ref = refs[p]
            o = {k: t.to(device) for k, t in out.items()}
            picked, dist = compare.nearest_anchors(o, ref)
            for k, v in compare.face_gaps(o, ref, picked, dist,
                                          cfg["conf_thres"],
                                          cfg["iou_thres"]).items():
                parts[k].append(v)
            gaps["keep_gap"].append(compare.keep_gaps(ref, picked, cfg))
            wrong += compare.slots_wrong(o, ref["count"])
            v = o["valid"]
            fidx = torch.nonzero(v)[:, 0]
            kps = o["kps"][v].float()
            key = (p, kps.cpu().numpy().tobytes())
            if key not in embs:
                embs[key] = reference_embeddings(rec_ref, frames, kps, fidx)
            gaps["emb_gap"].append(compare.emb_gaps(o["embeddings"][v],
                                                    embs[key]))
            gaps["match_gap"].append(compare.match_gaps(
                o["embeddings"][v].float(), o["match_idx"][v],
                o["match_sim"][v], gallery, cfg["similarity_thresh"]))
    res = {k: compare.worst(torch.cat(v)) if v else 0.0
           for k, v in gaps.items()}
    # the mean over the judged frames: the widest band over them reads
    # 0.04 on sound runs and 0.06-0.08 on the control, the mean does not
    # swing with one frame's cascade of near ties
    res["keep_gap"] = compare.mean(torch.cat(gaps["keep_gap"])) \
        if gaps["keep_gap"] else 0.0
    res["face_parts"] = {k: compare.worst(torch.cat(v)) if v else 0.0
                         for k, v in parts.items()}
    # the widest coordinate gap reads 0.034 on sound runs and 0.093 on the
    # control, too close to part them; its mean over the faces parts them
    geometry = torch.cat(parts["geometry"]) if parts["geometry"] \
        else torch.zeros(1)
    res["geometry_gap"] = compare.mean(geometry)
    res["geometry_quantiles"] = torch.nan_to_num(
        geometry.double(), nan=compare.INF).quantile(
            torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64,
                         device=geometry.device)).tolist()
    res["face_gap"] = max(v for k, v in res["face_parts"].items()
                          if k != "geometry")
    res["slots_wrong"] = wrong
    res["batches"] = len(kept)
    return res


def reference_detections(det_ref, frames, cfg, block: int = 16) -> Dict:
    """Every anchor of every frame and the reference's own selection."""
    import torch

    parts = []
    for f0 in range(0, frames.shape[0], block):
        net_in, scale = detect.letterbox(frames[f0:f0 + block],
                                         tuple(cfg["det_size"]))
        hd = detect.heads(det_ref, net_in, scale)
        sel = detect.select(hd, conf=cfg["conf_thres"], iou=cfg["iou_thres"],
                            pre_nms=cfg["pre_nms"], max_det=cfg["max_det"],
                            max_num=cfg["max_num"])
        hd.update(sel)
        parts.append(hd)
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def reference_embeddings(rec_ref, frames, kps, fidx, block: int = 256):
    import torch

    return torch.cat([align.embed(rec_ref, frames, kps[i:i + block],
                                  fidx[i:i + block])
                      for i in range(0, len(kps), block)]) if len(kps) \
        else torch.zeros((0, 1), device=frames.device)


def run(ctx) -> Dict:
    """One run of a stream cell; see the module's note."""
    import torch

    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    sd = seeds(ctx.seed)
    sync = (torch.cuda.synchronize if dev.type == "cuda" else (lambda: None))
    marks = [("start", time.perf_counter())]
    pool = frame_pool(traffic, sd["frames"], dev)
    sync()
    marks.append(("frames", time.perf_counter()))
    with torch.no_grad():
        det_ref, rec_ref, faces = reference_models(cfg, traffic, sd, pool,
                                                   dev)
        sync()
        marks.append(("weights", time.perf_counter()))
        pipe = program(cfg, traffic, det_ref, rec_ref, dev)
        marks.append(("export + import", time.perf_counter()))
        rows = gallery_rows(traffic, faces, sd["gallery"], dev)
    # the reference waits in host memory while the program runs
    det_ref, rec_ref = det_ref.cpu(), rec_ref.cpu()
    pipe.set_gallery(rows.cpu().numpy(),
                     [f"id{i}" for i in range(len(rows))])
    if traffic["feed"] == "card":
        batches = list(pool)
    else:                           # host memory only: drawn again to judge
        batches = [b.cpu().numpy() for b in pool]
    del pool
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("gallery + feed", time.perf_counter()))
    for _ in range(2):
        for _ in pipe.process_stream(iter(batches), max_num=cfg["max_num"],
                                     depth=traffic["depth"]):
            pass
    sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - ctx.started

    keep = np.random.default_rng(sd["judge"]).random(1 << 20) \
        < traffic["judge_share"]
    clock = None
    if ctx.trace:
        from scrfd_arcface_facerecognition_tpu_torch import stages

        clock = StageClock(torch, dev)
        stages.set_stage_hook(clock)
    try:
        w = window(pipe, batches, ctx.seconds, traffic["depth"],
                   cfg["max_num"], keep, sync, count_faces=ctx.trace)
    finally:
        if clock is not None:
            stages.set_stage_hook(None)
    frames, seconds, latency, kept = (w["frames"], w["seconds"],
                                      w["latency"], w["kept"])
    data = {"batches": len(latency), "frames": frames, "window_s": seconds,
            "faces": w["faces"]}
    if clock is not None:
        data["stage_ms"] = clock.totals_ms()
        data["trace"] = trace.traced(torch, lambda: window(
            pipe, batches, traffic["trace_seconds"], traffic["depth"],
            cfg["max_num"], np.zeros(0, bool), sync), dev)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    kept = {i: {k: getattr(o, k).cpu() for k in FIELDS}
            for i, o in kept.items()}
    del pipe, batches
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    pool = frame_pool(traffic, sd["frames"], dev)
    res = judge_batches(torch, cfg, pool, kept, rows, det_ref.to(dev),
                        rec_ref.to(dev), dev)
    t_ref = time.perf_counter() - t_ref
    lim = core.read_json(core.limits_file(ctx.cell))["limits"]
    checks = [compare.check(k, res[k], lim[k]) for k in CHECKS]
    if ctx.trace:
        add_counts(data, cfg, traffic, pool, kept)
    metrics = {"frames_per_s": core.rate(frames, seconds),
               "batch_p95_ms": core.tail(latency) * 1e3,
               "setup_s": setup_s}
    notes = [core.setup_said(ctx.started, marks),
             f"batches in the window {len(latency)}, judged "
             f"{res['batches']}, frames {frames}, window {seconds:.3f} s, "
             f"the comparison {t_ref:.2f} s",
             "widest face gap by part: " + ", ".join(
                 f"{k} {v:.6g}" for k, v in res["face_parts"].items()),
             "coordinate gaps over the faces, median, 90th and 99th "
             "percentiles: " + ", ".join(
                 f"{v:.6g}" for v in res["geometry_quantiles"])]
    return {"metrics": metrics, "data": data, "checks": checks,
            "attempted": len(latency), "failed": 0, "peak_bytes": peak,
            "notes": notes}


def add_counts(data: Dict, cfg, traffic, pool, kept) -> None:
    """The FLOPs a frame and a face need, the faces a batch, and K1's
    least time a launch (averaged over the judged batches; the valid
    crops only, as the work needs)."""
    import torch

    (ch, cw), _, _ = detect.letterbox_plan(
        (traffic["height"], traffic["width"]), tuple(cfg["det_size"]))
    data["det_flops"] = counts.model_flops(cfg["detector"], (3, ch, cw))
    data["rec_flops"] = counts.model_flops(cfg["embedder"], (3, 112, 112))
    bounds, faces = [], []
    b, h, w = pool.shape[1:4]
    for o in kept.values():
        v = o["valid"]
        faces.append(int(v.sum()))
        if not faces[-1]:
            continue
        fidx = torch.nonzero(v)[:, 0].to(pool.device)
        kps = o["kps"][v].float().to(pool.device)
        minv = align.inverse(align.similarity(kps))
        bounds.append(counts.k1_bound((b, h, w), minv, fidx, faces[-1])[0])
    data["faces_per_batch"] = float(np.mean(faces)) if faces else None
    data["k1_bound_s"] = float(np.mean(bounds)) if bounds else None
