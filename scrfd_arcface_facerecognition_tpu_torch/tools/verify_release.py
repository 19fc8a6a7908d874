"""One-command release sign-off on the port: all five graphs, graph level,
export round trip and end to end.

    python -m scrfd_arcface_facerecognition_tpu_torch.tools.verify_release \
        [--device cpu] [--weights ./weights] [--images DIR] [--mutate]

The port's counterpart of the JAX repository's ``tools/verify_release.py``,
with its stages, budgets, flags and exit codes. For each released file
(det_500m, det_2.5g, det_10g, w600k_mbf, w600k_r50):

- real mode (the file is under ``--weights``): the port's graph executor
  (``models/onnx_exec.py``) and its importer (``config_from_graph.
  variables_from_onnx`` into the native SCRFD / iResNet / MobileFaceNet)
  load the same bytes by two independent paths, and the importer is the
  oracle the executor is held to;
- stand-in mode (no file): the seeded full-width torch stand-in of
  ``tests/torch_export.py`` with the released graphs' op idioms is
  exported to ONNX and is the oracle for both load paths.

Every file is preflighted (``models.preflight_graph``) before any image
is read or any oracle built: a bad file exits 2 with ``SIGN-OFF FAIL``,
its class and a pointer to ``docs/RUNBOOK.md``. Then:

1. graph parity: executor and importer against the oracle on the
   letterboxed frames (detector: max |diff| of the 9 raw outputs;
   embedder: the worst cosine), and the export round trip: importer ->
   ``onnx_export.export_model`` -> executor, against the importer;
2. end to end: ``FaceAnalysis`` on the files (detect, decode, NMS,
   max_num, Umeyama, the K1 warp on the card, embed, L2) against the
   reference replica of ``tools/e2e_oracle.py`` on the same frames: face
   counts, boxes, landmarks, scores, embedding cosines and the agreement
   of face-to-face similarities;
3. a report (default ``build/signoff/PARITY.md``); exit 0 iff every graph
   and pairing is within the budgets.

The port's forwards run in float32 with TF32 off for matmuls and cuDNN
(``device.full_f32``): PyTorch's cuDNN default lets convolutions take
TF32, which would put ~1e-3 to 1e-2 of noise into an exactness check. The
oracle's stand-ins run on the CPU in float32. Runs on the card unless
``--device cpu``. Without ``--images`` the frames are ``--n`` seeded
synthetic ones of mixed sizes; ``--images DIR`` reads its JPEGs with cv2.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import os
import subprocess
import sys
import zlib

import numpy as np

from . import e2e_oracle as eo

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(REPO_ROOT, "build", "signoff")

DETS = ["det_500m", "det_2.5g", "det_10g"]
RECS = ["w600k_mbf", "w600k_r50"]

E2E_PAIRS = [("det_10g", "w600k_r50"),    # the reference's defaults
             ("det_500m", "w600k_mbf")]   # the small pairing

DET_RAW_BUDGET = 1e-2      # raw outputs; decode / NMS decisions held e2e
COS_BUDGET = 1e-3          # the embedding budget
BOX_BUDGET = 0.5           # px, image coordinates
KPS_BUDGET = 0.5           # px
SCORE_BUDGET = 1e-3


def torch_export():
    """``tests/torch_export.py`` (the stand-ins and their exporter), loaded
    by file path: it imports torch only."""
    import importlib.util

    src = os.path.join(REPO_ROOT, "tests", "torch_export.py")
    spec = importlib.util.spec_from_file_location("torch_export", src)
    te = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(te)
    return te


def load_images(images_dir: str, n: int):
    """Up to ``n`` readable JPEGs of ``images_dir``, unreadable ones
    skipped before counting (cv2, imported here)."""
    import cv2

    imgs = []
    for p in sorted(glob.glob(os.path.join(images_dir, "*.jpg"))):
        im = cv2.imread(p)
        if im is None:
            print(f"warning: unreadable image skipped: {p}")
            continue
        imgs.append(im)
        if len(imgs) == n:
            break
    return imgs


def resolve_graph(name: str, weights_dir, tmpdir: str, mutate: bool = False):
    """-> (onnx path, stand-in module or None, mode). A file under
    ``weights_dir`` is real; otherwise the seeded stand-in (crc32 seed,
    the detector calibrated) is exported under ``tmpdir``, named by its
    architecture and weights, and reused while they stay. ``mutate`` takes the width / depth
    perturbed stand-ins, which prove that the load path reads the
    architecture from the graph."""
    import torch

    real = os.path.join(weights_dir, f"{name}.onnx") if weights_dir else None
    if real and os.path.exists(real):
        return real, None, "real"
    te = torch_export()
    ctors = dict(te.STAND_INS)
    mode = "standin"
    if mutate:
        ctors.update(te.MUTATED_STAND_INS)
        if name in te.MUTATED_STAND_INS:
            mode = "mutated"
    tm = te.seeded(ctors[name](), seed=zlib.crc32(name.encode()) % 1000)
    if name.startswith("det"):
        tm = te.calibrate_detector(tm)
    os.makedirs(tmpdir, exist_ok=True)
    path = os.path.join(tmpdir, f"{name}_{mode}_{module_key(tm)}.onnx")
    if not os.path.exists(path):
        side = 640 if name.startswith("det") else 112
        part = f"{path}.{os.getpid()}.tmp"
        te.export_onnx(tm, torch.randn(1, 3, side, side), part)
        os.replace(part, path)
    return path, tm.eval(), mode


def module_key(module) -> str:
    """crc32 of a module's architecture and weights: the name of its
    exported file, so that a cached export is the module's own."""
    key = zlib.crc32(repr(module).encode())
    for name, t in module.state_dict().items():
        key = zlib.crc32(name.encode(), key)
        key = zlib.crc32(t.detach().cpu().contiguous().numpy().tobytes(),
                         key)
    return f"{key:08x}"


def exact_f32():
    """The block the port's compared forwards run in: no autograd, float32
    without TF32."""
    import torch

    from ..device import full_f32

    stack = contextlib.ExitStack()
    stack.enter_context(torch.no_grad())
    stack.enter_context(full_f32())
    return stack


def importer_model(name: str, onnx_path: str, device):
    """(config, Flax-layout tree, native module on ``device``) of the file
    through the port's importer; the architecture is inferred from the
    graph, never looked up in a registry."""
    from ..models.arcface import arcface_from_config
    from ..models.config_from_graph import variables_from_onnx
    from ..models.scrfd import SCRFDNet
    from ..models.weights import load_flax_variables

    cfg, tree = variables_from_onnx(onnx_path, name=name)
    module = (SCRFDNet(cfg) if hasattr(cfg, "strides")
              else arcface_from_config(cfg))
    load_flax_variables(module, tree)
    return cfg, tree, module.to(device).eval()


def module_forward(module, is_det: bool, device):
    """A native port module as a forward callback (numpy NCHW -> numpy)."""
    import torch

    def fwd(blob):
        with exact_f32():
            out = module(torch.from_numpy(np.ascontiguousarray(
                blob, np.float32)).to(device))
        if is_det:
            return [t.float().cpu().numpy()
                    for t in out["scores"] + out["bboxes"] + out["kps"]]
        return out.float().cpu().numpy()
    return fwd


def importer_forwards(name: str, onnx_path: str, device):
    return module_forward(importer_model(name, onnx_path, device)[2],
                          name.startswith("det"), device)


def executor_forwards(onnx_path: str, is_det: bool, device):
    """The port's graph executor on the file, at float32."""
    import torch

    from ..models.onnx_exec import onnx_model

    m = onnx_model(onnx_path, dtype=torch.float32, device=device)

    def fwd(blob):
        with exact_f32():
            out = m(torch.from_numpy(np.ascontiguousarray(
                blob, np.float32)).to(device))
        if is_det:
            return [t.float().cpu().numpy() for t in out]
        return out[0].float().cpu().numpy()
    return fwd


def torch_forward(tm, is_det: bool):
    return eo.torch_det_forward(tm) if is_det else eo.torch_rec_forward(tm)


def _blob(im, is_det: bool):
    if is_det:
        return eo.det_blob(eo.letterbox(im)[0])
    return eo.rec_blob([eo.center_crop112(im)])


def cosine(g, w) -> float:
    g, w = np.asarray(g).reshape(-1), np.asarray(w).reshape(-1)
    return float(np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w)
                                 + 1e-12))


def graph_parity(name: str, onnx_path: str, oracle_fwd, imgs, device,
                 compare_importer: bool = True):
    """Stage 1: the executor (and the importer) against the oracle.

    In real mode the importer IS the oracle, so ``compare_importer`` is
    False: a second importer held to the first would pass by
    construction."""
    is_det = name.startswith("det")
    paths = [("exec", executor_forwards(onnx_path, is_det, device))]
    if compare_importer:
        paths.append(("imp", importer_forwards(name, onnx_path, device)))
    worst = {"exec_diff": 0.0, "imp_diff": 0.0,
             "exec_cos": 1.0, "imp_cos": 1.0}
    for im in imgs:
        blob = _blob(im, is_det)
        want = oracle_fwd(blob)
        for key, fwd in paths:
            got = fwd(blob)
            if is_det:
                if len(got) != len(want):
                    raise SystemExit(
                        f"{name}: output count mismatch — {key} produced "
                        f"{len(got)} tensors, oracle {len(want)}")
                d = max(float(np.abs(g - w).max())
                        for g, w in zip(got, want))
                worst[f"{key}_diff"] = max(worst[f"{key}_diff"], d)
            else:
                worst[f"{key}_cos"] = min(worst[f"{key}_cos"],
                                          cosine(got, want))
                worst[f"{key}_diff"] = max(worst[f"{key}_diff"], float(
                    np.abs(np.asarray(got).reshape(-1)
                           - np.asarray(want).reshape(-1)).max()))
    return worst


def export_roundtrip(name: str, onnx_path: str, imgs, tmpdir: str, device):
    """Stage 1b: the graph through the importer, written again by
    ``onnx_export.export_model``, the new bytes through the executor,
    against the importer's forward: released bytes -> port weights -> a
    new .onnx -> executor keeps the function."""
    from ..models.onnx_export import export_model

    is_det = name.startswith("det")
    cfg, tree, module = importer_model(name, onnx_path, device)
    imp_fwd = module_forward(module, is_det, device)
    rt_path = os.path.join(tmpdir, f"{name}_roundtrip.onnx")
    export_model(cfg, tree, rt_path)
    exec_fwd = executor_forwards(rt_path, is_det, device)
    worst = {"diff": 0.0, "cos": 1.0}
    for im in imgs:
        blob = _blob(im, is_det)
        want, got = imp_fwd(blob), exec_fwd(blob)
        if is_det:
            worst["diff"] = max(worst["diff"],
                                max(float(np.abs(g - w).max())
                                    for g, w in zip(got, want)))
        else:
            worst["cos"] = min(worst["cos"], cosine(got, want))
            worst["diff"] = max(worst["diff"], float(
                np.abs(np.asarray(got).reshape(-1)
                       - np.asarray(want).reshape(-1)).max()))
    return worst


def pick_threshold(oracle, imgs, target: int = 40):
    """A conf threshold giving at most ``target`` candidates an image, at
    the midpoint of the widest score gap near that operating point, so
    that raw-output differences of ~1e-5 cannot flip a threshold decision
    (random stand-in weights put sigmoid scores in a continuum)."""
    per_image_kth, pooled = [], []
    for im in imgs:
        outs = oracle.raw_outputs(im)
        scores = np.concatenate([outs[i].ravel() for i in range(3)])
        pooled.append(np.sort(scores)[-4 * target:])
        per_image_kth.append(np.sort(scores)[-target])
    t0 = float(max(per_image_kth))
    pooled = np.sort(np.unique(np.concatenate(pooled)))
    i = int(np.searchsorted(pooled, t0))
    lo = pooled[max(i - 1, 0)]
    hi = pooled[min(i, len(pooled) - 1)]
    return float((lo + hi) / 2) if hi > lo else t0 + 1e-4


def pick_iou_thres(oracle, imgs, around: float = 0.4,
                   window: float = 0.15) -> float:
    """An IoU threshold in the widest gap of the candidates' pairwise IoU
    near ``around``: the NMS counterpart of ``pick_threshold``, with the
    +1-offset IoU that ``greedy_nms`` applies."""
    ious = []
    for im in imgs:
        det = oracle.candidates(im)[:96]
        if len(det) < 2:
            continue
        ious.append(eo.pairwise_iou_legacy(det).ravel())
    pool = np.sort(np.unique(np.concatenate(ious))) if ious else np.array([])
    lo, hi = around - window, around + window
    inside = pool[(pool > lo) & (pool < hi)]
    edges = np.concatenate([[lo], inside, [hi]])
    g = int(np.argmax(np.diff(edges)))
    return float((edges[g] + edges[g + 1]) / 2)


def e2e_parity(det_name, rec_name, det_path, rec_path, det_oracle_fwd,
               rec_oracle_fwd, imgs, device, conf_thres=None, max_num=10):
    """Stage 2: ``FaceAnalysis`` on the files against the replica.
    Returns the worst-case metrics."""
    import torch

    from ..apps.face_analysis import FaceAnalysis

    oracle = eo.OracleStack(det_oracle_fwd, rec_oracle_fwd)
    if conf_thres is None:
        conf_thres = pick_threshold(oracle, imgs)
    oracle.conf_thres = conf_thres
    iou_thres = pick_iou_thres(oracle, imgs)
    oracle.iou_thres = iou_thres

    # max_det above the NMS survivors: the pipeline keeps its post-NMS
    # slate by score before max_num ranks by area, so a tighter slate than
    # the oracle's unbounded list would compare different face sets
    app = FaceAnalysis(det_variant=det_name, rec_variant=rec_name,
                       det_onnx=det_path, rec_onnx=rec_path,
                       dtype=torch.float32, max_det=64,
                       pipeline_kwargs=dict(tight_canvas=False),
                       device=device)
    app.detector.iou_thres = iou_thres
    app.prepare(det_thresh=conf_thres)
    with exact_f32():
        faces_per_img = app.get_batch(imgs, max_num=max_num)

    worst = {"count_mismatch": 0, "box": 0.0, "kps": 0.0, "score": 0.0,
             "cos": 1.0, "simdiff": 0.0, "n_faces": 0, "n_strict": 0,
             "tie_swaps": 0, "hidden_ties": 0, "thresh": conf_thres,
             "iou": iou_thres}
    prev_emb_port = prev_emb_or = None

    def sig(score, box):
        return np.array([score,
                         (box[2] - box[0]) * (box[3] - box[1]) * 1e-4])

    for im, faces in zip(imgs, faces_per_img):
        det_o, kps_o, emb_o = oracle.process(im, max_num=max_num)
        hidden = hidden_tied(oracle.candidates(im), det_o, iou_thres)
        if len(faces) != len(det_o):
            worst["count_mismatch"] += 1
            continue
        worst["n_faces"] += len(faces)
        if not faces:
            continue
        # pair by the (score, area) signature the selection sorts on; with
        # random stand-in weights the zero pad band gives groups of
        # anchors identical activations, and argsorts may pick different
        # members: those are tie swaps, the rest is compared strictly
        p_sigs = np.stack([sig(f.det_score, np.asarray(f.bbox))
                           for f in faces])
        o_sigs = np.stack([sig(det_o[i, 4], det_o[i, :4])
                           for i in range(len(det_o))])
        cost = np.abs(p_sigs[:, None, :] - o_sigs[None, :, :]).sum(-1)
        pairs, used_p, used_o = [], set(), set()
        for flat in np.argsort(cost, axis=None):
            pi, oi = np.unravel_index(flat, cost.shape)
            if pi in used_p or oi in used_o:
                continue
            pairs.append((int(pi), int(oi)))
            used_p.add(int(pi))
            used_o.add(int(oi))
            if len(pairs) == len(faces):
                break
        tie_eps = 1e-6
        for pi, oi in pairs:
            f = faces[pi]
            # a score tied with another candidate's on either side sits in
            # an NMS tie chain, whose survivors depend on an unspecified
            # argsort order: kept out of the strict comparison
            dup = (any(x != pi and abs(float(p_sigs[x][0] - p_sigs[pi][0]))
                       < tie_eps for x in range(len(faces)))
                   or any(x != oi and abs(float(o_sigs[x][0] - o_sigs[oi][0]))
                          < tie_eps for x in range(len(det_o))))
            if dup:
                worst["tie_swaps"] += 1
                continue
            worst["n_strict"] += 1
            worst["hidden_ties"] += int(hidden[oi])
            worst["score"] = max(worst["score"], abs(
                float(f.det_score) - float(det_o[oi, 4])))
            worst["box"] = max(worst["box"], float(
                np.abs(np.asarray(f.bbox) - det_o[oi, :4]).max()))
            worst["kps"] = max(worst["kps"], float(
                np.abs(np.asarray(f.kps) - kps_o[oi]).max()))
            worst["cos"] = min(worst["cos"], float(
                np.dot(f.normed_embedding, emb_o[oi])))
            if prev_emb_port is not None:
                s_port = float(np.dot(f.normed_embedding, prev_emb_port))
                s_or = float(np.dot(emb_o[oi], prev_emb_or))
                worst["simdiff"] = max(worst["simdiff"], abs(s_port - s_or))
            prev_emb_port = np.asarray(f.normed_embedding)
            prev_emb_or = emb_o[oi]
    return worst


def hidden_tied(candidates, det_o, iou_thres, tie_eps=1e-6):
    """For each face the replica kept: whether a pre-NMS candidate that
    overlaps it past ``iou_thres`` has its score to ``tie_eps``. The tie
    rule above looks only at the kept faces, so a chain whose other
    members NMS suppressed is compared strictly, and a score moved by
    rounding can keep a neighbour one anchor stride away. Reported, not
    part of the verdict."""
    iou = eo.pairwise_iou_legacy(candidates)
    out = []
    for d in det_o:
        i = int(np.flatnonzero((candidates == d).all(1))[0])
        tied = np.abs(candidates[:, 4] - candidates[i, 4]) < tie_eps
        tied[i] = False
        out.append(bool((tied & (iou[i] > iou_thres)).any()))
    return out


def e2e_passed(w) -> bool:
    """n_strict > 0: the budgets must have been exercised; if every face
    fell in a tie chain the metrics keep their initial values."""
    return (w["count_mismatch"] == 0 and w["n_faces"] > 0
            and w["n_strict"] > 0
            and w["box"] < BOX_BUDGET and w["kps"] < KPS_BUDGET
            and w["score"] < SCORE_BUDGET
            and w["cos"] > 1 - COS_BUDGET
            and w["simdiff"] < COS_BUDGET)


def device_said(device) -> str:
    """The device the port ran on: the card's name and power limit as
    nvidia-smi gives them, or the CPU."""
    if device.type != "cuda":
        return "CPU"
    import torch

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        line = out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else None
    except (OSError, IndexError, subprocess.TimeoutExpired):
        line = None
    return line or f"{torch.cuda.get_device_name(device)} (nvidia-smi " \
                   "gave no power limit)"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the port runs (cuda | cpu)")
    ap.add_argument("--weights", default="./weights",
                    help="directory with released det_*.onnx / w600k_*.onnx")
    ap.add_argument("--images", default=None,
                    help="a directory of JPEGs (read with cv2); without it "
                         "--n seeded synthetic frames of mixed sizes")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="the report (default build/signoff/PARITY.md, "
                         "PARITY_mutated.md with --mutate)")
    ap.add_argument("--skip-e2e", action="store_true")
    ap.add_argument("--skip-export", action="store_true",
                    help="skip the importer -> exporter -> executor round "
                         "trip")
    ap.add_argument("--conf-thres", type=float, default=None,
                    help="override the picked sign-off threshold")
    ap.add_argument("--mutate", action="store_true",
                    help="width / depth perturbed stand-ins (the importer "
                         "reads the architecture from the graph)")
    return ap.parse_args(argv)


def run(args, device) -> dict:
    """The sign-off: {"code", "rows", "e2e", "source"}. ``code`` is 2
    when a file failed preflight (nothing else ran), else 0 iff every
    graph and pairing is within the budgets. Each row holds its raw
    worst-case numbers."""
    from ..models.preflight import ReleaseFileError, preflight_graph

    tmpdir = os.path.join(OUT_DIR, "graphs")
    # every file resolved and preflighted before any image or oracle: a
    # truncated download, a kind swapped under a name or an unsupported
    # op fails here with its class (docs/RUNBOOK.md gives the remedy)
    graphs = {}
    for name in DETS + RECS:
        path, tm, mode = resolve_graph(name, args.weights, tmpdir,
                                       mutate=args.mutate)
        try:
            facts = preflight_graph(path, "det" if name.startswith("det")
                                    else "rec")
        except ReleaseFileError as e:
            print(f"SIGN-OFF FAIL — {e}")
            print("See docs/RUNBOOK.md for the per-class remedy.")
            return dict(code=2, rows=[], e2e=[], source=None)
        print(f"[preflight] {name} ({mode}): {facts['family']}, "
              f"{facts['n_nodes']} nodes, {facts['n_outputs']} outputs OK")
        graphs[name] = (path, tm, mode)

    if args.images:
        imgs = load_images(args.images, args.n)
        if not imgs:
            print(f"no images under {args.images}")
            return dict(code=1, rows=[], e2e=[], source=None)
        source = f"{len(imgs)} JPEGs from `{args.images}`"
    else:
        imgs = eo.synthetic_frames(args.n)
        source = (f"{len(imgs)} seeded synthetic frames ("
                  + ", ".join(sorted({f"{im.shape[0]}x{im.shape[1]}"
                                      for im in imgs})) + ")")
    print(f"frames: {source}")

    rows, oracle_fwds, ok = [], {}, True
    for name in DETS + RECS:
        path, tm, mode = graphs[name]
        is_det = name.startswith("det")
        # real file: the importer is the independent oracle, and the
        # executor-vs-importer diff is the two-load-paths check
        oracle_fwds[name] = (importer_forwards(name, path, device)
                             if mode == "real" else torch_forward(tm, is_det))
        w = graph_parity(name, path, oracle_fwds[name], imgs, device,
                         compare_importer=(mode != "real"))
        rt = (None if args.skip_export
              else export_roundtrip(name, path, imgs[:2], tmpdir, device))
        if is_det:
            passed = (w["exec_diff"] < DET_RAW_BUDGET
                      and w["imp_diff"] < DET_RAW_BUDGET
                      and (rt is None or rt["diff"] < DET_RAW_BUDGET))
        else:
            passed = (w["exec_cos"] > 1 - COS_BUDGET
                      and w["imp_cos"] > 1 - COS_BUDGET
                      and (rt is None or rt["cos"] > 1 - COS_BUDGET))
        row = dict(name=name, mode=mode, path=path, graph=w, rt=rt,
                   passed=passed)
        rows.append(row)
        ok &= passed
        cells = row_cells(row)
        print(f"[graph] {name} ({mode}): exec {cells[2]} imp {cells[3]} "
              + ("" if is_det else f"cos {cells[4]} ")
              + f"export-rt {cells[5]} " + cells[6])

    e2e_rows = []
    if not args.skip_e2e:
        for det_name, rec_name in E2E_PAIRS:
            w = e2e_parity(det_name, rec_name, graphs[det_name][0],
                           graphs[rec_name][0], oracle_fwds[det_name],
                           oracle_fwds[rec_name], imgs, device,
                           conf_thres=args.conf_thres)
            passed = e2e_passed(w)
            e2e_rows.append(dict(pair=f"{det_name}+{rec_name}", e2e=w,
                                 passed=passed))
            ok &= passed
            print(f"[e2e] {det_name}+{rec_name}: conf {w['thresh']:.6f} "
                  f"iou {w['iou']:.4f} faces {w['n_faces']} (strict "
                  f"{w['n_strict']}) mismatch {w['count_mismatch']} ties "
                  f"{w['tie_swaps']} hidden ties {w['hidden_ties']} box "
                  f"{w['box']:.2e}px kps "
                  f"{w['kps']:.2e}px score {w['score']:.2e} cos "
                  f"{w['cos']:.6f} simdiff {w['simdiff']:.2e} "
                  + ("PASS" if passed else "FAIL"))
    return dict(code=0 if ok else 1, rows=rows, e2e=e2e_rows, source=source)


def row_cells(row):
    """A graph row's report cells: name, mode, executor diff, importer
    diff, worst cosine, round trip, verdict."""
    w, rt, is_det = row["graph"], row["rt"], row["name"].startswith("det")
    imp = f"{w['imp_diff']:.2e}" if row["mode"] != "real" else "(=oracle)"
    if rt is None:
        rt_cell = "-"
    else:
        rt_cell = f"{rt['diff']:.2e}" if is_det else f"{rt['cos']:.6f}"
    cos = "-" if is_det else f"{min(w['exec_cos'], w['imp_cos']):.6f}"
    return (row["name"], row["mode"], f"{w['exec_diff']:.2e}", imp, cos,
            rt_cell, "PASS" if row["passed"] else "FAIL")


def main(argv=None) -> int:
    from ..device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    res = run(args, device)
    if res["source"] is None:
        return res["code"]
    out = args.out or os.path.join(
        OUT_DIR, "PARITY_mutated.md" if args.mutate else "PARITY.md")
    write_report(out, res, device_said(device), args)
    print(f"report {out} written — overall "
          f"{'PASS' if res['code'] == 0 else 'FAIL'}")
    return res["code"]


def write_report(out, res, device, args) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write("# PARITY — release sign-off of the PyTorch port\n\n")
        f.write(f"Frames: {res['source']}. Device: **{device}**. The port's "
                "forwards ran in float32 with TF32 off for matmuls and "
                "cuDNN; the oracle's stand-ins on the CPU in float32."
                + (" Mutated stand-ins (--mutate)." if args.mutate else "")
                + "\n\n")
        f.write("## Graph level (executor + importer vs oracle; export "
                "round trip = importer -> onnx_export -> executor)\n\n")
        f.write("| graph | mode | executor max\\|diff\\| | importer "
                "max\\|diff\\| | worst cosine | export round trip | "
                "verdict |\n|---|---|---|---|---|---|---|\n")
        for row in res["rows"]:
            f.write("| " + " | ".join(row_cells(row)) + " |\n")
        if res["e2e"]:
            f.write("\n## End to end (FaceAnalysis vs the reference "
                    "replica)\n\n")
            f.write("| pairing | conf | iou | faces | strict | count "
                    "mismatches | tie swaps | hidden ties | box px | kps px "
                    "| score | worst cosine | sim diff | verdict |\n"
                    "|---|---|---|---|---|---|---|---|---|---|---|---|---|"
                    "---|\n")
            for r in res["e2e"]:
                w = r["e2e"]
                f.write(f"| {r['pair']} | {w['thresh']:.6f} | "
                        f"{w['iou']:.4f} | {w['n_faces']} | "
                        f"{w['n_strict']} | {w['count_mismatch']} | "
                        f"{w['tie_swaps']} | {w['hidden_ties']} | "
                        f"{w['box']:.2e} | "
                        f"{w['kps']:.2e} | {w['score']:.2e} | "
                        f"{w['cos']:.6f} | {w['simdiff']:.2e} | "
                        f"{'PASS' if r['passed'] else 'FAIL'} |\n")
            f.write("\n*tie swaps* count faces kept out of the strict "
                    "comparison because their score ties another "
                    "candidate's exactly (random stand-in weights give the "
                    "zero pad band identical activations at many anchors, "
                    "and greedy NMS then keeps one of a chain by an "
                    "unspecified argsort order). *hidden ties* count "
                    "strictly compared faces whose replica candidate has a "
                    "suppressed neighbour of the same score: such a chain "
                    "is outside the tie rule, and a score moved by rounding "
                    "there keeps the neighbour, one anchor stride away. "
                    "Real weights on real content give no exact ties.\n")
        else:
            f.write("\nEnd to end: skipped (--skip-e2e).\n")
        f.write(f"\n**Overall: {'PASS' if res['code'] == 0 else 'FAIL'}** "
                f"— budgets: det raw {DET_RAW_BUDGET}, cosine {COS_BUDGET}, "
                f"box / kps {BOX_BUDGET} px, score {SCORE_BUDGET}.\n")


if __name__ == "__main__":
    sys.exit(main())
