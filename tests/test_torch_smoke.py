"""The parts of chip_smoke.py that need no card, on the CPU.

The card-vs-CPU phase compares the two with TF32 off; it must leave the
process's TF32 settings as it found them, since the phases after it time
the paths at PyTorch's defaults. Without a CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke  # noqa: E402
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")


def _tf32():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def test_card_vs_cpu_phase_leaves_the_tf32_settings(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    rep = chip_smoke.Report("CPU")
    chip_smoke.phase_card_vs_cpu(torch, rep)        # touches no setting
    assert _tf32() == (True, True)
    with chip_smoke.full_f32(torch):
        assert _tf32() == (False, False)
        chip_smoke.phase_card_vs_cpu(torch, rep)
    assert _tf32() == (True, True)
    with pytest.raises(RuntimeError):
        with chip_smoke.full_f32(torch):
            chip_smoke.fail("a failing phase")
    assert _tf32() == (True, True)


def test_bounds_count_the_bytes_each_input_and_output_moves_once():
    ms, by, nbytes = chip_smoke.k4_bound(64, 56, 96, 256, 56)
    assert nbytes == 2 * 64 * 56 * 96 * 256 * 2 + 9 * 56 * 56 * 2 + 2 * 56 * 4
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e9)


def test_k3_bound_counts_only_what_the_crops_need():
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_params as wp
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_warp2

    frames, canvas, _, _, prm = exp_warp2.make_workload(
        np.random.default_rng(0), 1, 4, fh=320, fw=640, device="cpu")
    fp, cp = wp.planarize(frames), wp.planarize(canvas)
    bd = chip_smoke.k3_bound(fp, cp, prm)
    counts, hit_f, hit_c = exp_warp2.needed(fp, cp, prm)
    assert bd["src_px"] == int(hit_f.sum()) + int(hit_c.sum()) > 0
    assert bd["bytes"] == 4 * 3 * 112 * 112 * 4 + 4 * 64 + 3 * bd["src_px"]
    assert bd["positions"] == sum(counts) < 4 * (192 * 512 + 3 * 192 * 192
                                                + 112 * 112)
    t_bytes, t_ops = bd["bytes"] / 3.35e9, bd["flops"] / 67e9
    assert bd["ms"] == pytest.approx(max(t_bytes, t_ops))
    assert bd["by"] == ("bytes" if t_bytes >= t_ops else "operations")
    # the fused kernel computes each pass over fused_plan's ranges: all
    # that is needed, and far less than every position of every pass
    plan = exp_warp2.fused_plan(prm)
    l4, l3, ys = (plan[:, 1] - plan[:, 0], plan[:, 3] - plan[:, 2],
                  plan[:, 5] - plan[:, 4])
    computed = [112 * l4, ys * l4, ys * l3]
    assert all(n <= int(c.sum()) for n, c in zip(counts[1:4], computed))
    assert sum(int(c.sum()) for c in computed) < 0.5 * 4 * 3 * 192 * 192


def test_k4_cases_cover_the_kernels_paths(monkeypatch):
    """Phase 10's shapes reach C and F above 64 and off 16, Wp above one
    256-position tile, Wp on and off the 8-lane grid (the kernel's vector
    and lane-by-lane staging); the non-finite case puts a NaN, a +inf and
    a -inf pixel in x, the -inf on the circular lane Wp - 1."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_pallas_conv

    shapes = [chip_smoke.K4_SHAPES] + [s for _, s in chip_smoke.K4_CASES]
    assert any(s["c"] > 64 and s["c"] % 16 and s["f"] > 64 and s["f"] % 16
               for s in shapes)
    assert any(s["wp"] > 256 for s in shapes)
    assert {s["wp"] % 8 == 0 for s in shapes} == {True, False}
    assert all(s["h"] % 8 == 0 for s in shapes)
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    x, w3, k, sc, bi = chip_smoke.k4_case(
        torch, exp_pallas_conv, np.random.default_rng(0),
        dict(b=2, h=8, w=10, c=4, f=8, wp=12), nonfinite=True)
    assert int(torch.isnan(x).sum()) == 1
    assert int(torch.isinf(x).sum()) == 2
    assert float(x[..., -1].float().min()) == -float("inf")
    want = exp_pallas_conv.conv3x3_plain(x, w3, sc, bi)
    assert bool(torch.isnan(want).any()) and bool(torch.isinf(want).any())


def _no_card(monkeypatch, wa):
    """chip_smoke on the CPU: the wrappers take their plain versions,
    times read 0 and the occupancy query answers without a library."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda torch, fn, **kw: (fn(), 0.0)[1])
    monkeypatch.setattr(wa, "occupancy", lambda lib=None: dict(
        threads=224, rows=8, blocks_per_sm=0, regs=0))
    said = []
    rep = chip_smoke.Report("CPU")
    monkeypatch.setattr(rep, "say", said.append)
    return rep, said


def test_k1_edge_sets_reach_the_kernels_edges():
    """Phase 3's edge sets: no crop and one crop, an output width off the
    4-pixel quads, a height off the tiles' rows (2, 4 or 8), a width of
    three 112-column tiles, frame indices below 0 and at or past B,
    frames smaller than a crop's footprint."""
    edges = chip_smoke.K1_EDGES
    assert {nc for _, _, _, _, nc, _, _ in edges} >= {0, 1}
    assert any(hw[1] % 4 for *_, hw, _ in edges)
    assert any(hw[0] % 2 for *_, hw, _ in edges)
    assert any(hw[1] > 224 for *_, hw, _ in edges)
    assert any(off > 0 for *_, off in edges)
    assert any(h < 56 and w < 56 for _, _, h, w, *_ in edges)
    assert chip_smoke.K1_BENCH == (96, 1080, 1920, 960)


def test_k1_phase_rehearsed_on_the_cpu(monkeypatch):
    """Phase 3 at small sizes through the wrapper's plain version: every
    set compared (0 u8 against itself), out-of-range frame indices among
    them, no launch counted, each edge set and the bench-size timing
    reported."""
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    rep, said = _no_card(monkeypatch, wa)
    monkeypatch.setattr(chip_smoke, "K1_CASE", (2, 64, 96, 12))
    monkeypatch.setattr(chip_smoke, "K1_BENCH", (3, 48, 64, 9))
    seen = []
    plain = wa.warp_align_plain

    def watched(frames, minv, frame_idx, out_hw=(112, 112)):
        seen.append((frames.shape[0], frame_idx.clone(), out_hw))
        return plain(frames, minv, frame_idx, out_hw)

    monkeypatch.setattr(wa, "warp_align_plain", watched)
    before = wa.launches
    assert chip_smoke.phase_kernel_vs_plain(torch, wa, rep) == 0.0
    assert wa.launches == before
    edges = [s for s in said if s.startswith("K1 vs plain on its edge sets")]
    assert len(edges) == 1
    for name, *_ in chip_smoke.K1_EDGES:
        assert f"{name} 0;" in edges[0] + ";", name
    assert any(((fi < 0) | (fi >= nb)).any() for nb, fi, _ in seen)
    assert {hw for *_, hw in seen} >= {(112, 110), (13, 7), (9, 230)}
    assert any(s.startswith("K1 at 3x48x64 / 9 crops") for s in said)
    assert any("CTAs an SM (occupancy API)" in s for s in said)


def test_main_path_phase_rehearsed_on_the_cpu(monkeypatch):
    """Phase 4 at a small size (det_500m + w600k_mbf, 2 frames): the launch
    count read from the path, K1 at the path's shapes beside
    crop_matrices."""
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    rep, said = _no_card(monkeypatch, wa)

    class Event:
        def __init__(self, **kw):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 0.0

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(chip_smoke, "MAIN", dict(
        det="det_500m", rec="w600k_mbf", frames=2, hw=(96, 128), max_num=2,
        gallery=4))
    crops = ops.warp_align_crops

    def counted(*args, **kw):
        wa.launches += 1
        return crops(*args, **kw)

    monkeypatch.setattr(ops, "warp_align_crops", counted)
    launches, err, t, emb = chip_smoke.phase_main_path(torch, rep)
    assert launches == 5 and err == 0.0
    assert emb.shape[1] == 512 and t["bound_by"] == "bytes"
    line = [s for s in said if s.startswith("K1 at the main path's shapes")]
    assert len(line) == 1 and "crop_matrices (umeyama + inverse)" in line[0]


def test_standin_expectation_is_said_and_zero_faces_fail():
    assert "NOT MET" in chip_smoke.standin_expectation(80, 80)
    assert "expectation met" in chip_smoke.standin_expectation(37, 80)
    with pytest.raises(RuntimeError):
        chip_smoke.standin_expectation(0, 80)


@pytest.mark.parametrize("alone", [False, True])
def test_smoke_exits_nonzero_without_a_card_or_the_repository(tmp_path,
                                                              alone):
    cwd = _REPO
    if alone:
        shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_k2_cases_reach_the_kernels_edges(monkeypatch):
    """Phase 6 reaches a part-filled last chunk for both group widths (8
    bf16, 4 f32), codes views off 16-byte alignment, a table staged in
    three slabs (16-byte records of M * K entries above two blocks' 227
    KB), and K % 4 != 0 (the LUT staged entry by entry), in one slab and
    in more. On the CPU at small sizes the phase runs its case count
    through the wrapper's plain version."""
    qs = chip_smoke.K2_GRID["q"]
    assert any(q > 8 and q % 8 for q in qs) and any(q > 4 and q % 4
                                                    for q in qs)
    edges = chip_smoke.K2_EDGES
    assert {o % 16 != 0 for _, _, _, o in edges} == {True, False}
    assert any(m * k * 16 > 2 * 232448 for m, k, _, _ in edges)
    assert {m * k * 16 > 232448 for m, k, _, _ in edges if k % 4} == {
        True, False}
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "K2_GRID",
                        dict(q=(1, 3, 13), g=(0, 1, 70), k=(16, 32)))
    monkeypatch.setattr(chip_smoke, "K2_EDGES", ((64, 256, 50, 3),
                                                 (32, 10, 40, 0)))
    said = []
    rep = chip_smoke.Report("CPU")
    monkeypatch.setattr(rep, "say", said.append)
    before = pq_adc.launches
    assert chip_smoke.phase_k2_vs_plain(torch, pq_adc, rep) == 0.0
    assert pq_adc.launches == before
    # M=64: 2 K x 3 Q x 3 G; M=12: 2 K x 3 Q x 3 G; edges: 2 x 3 Q; x 2
    assert said[0].startswith(f"K2 vs plain, {(18 + 18 + 6) * 2} cases")
    view = chip_smoke.k2_codes(torch, np.random.default_rng(0), 5, 64, 256, 3)
    assert view.is_contiguous() and view.data_ptr() % 16 == 3


def _phase12_on_the_cpu(monkeypatch):
    """chip_smoke's phase 12 at small sizes on the CPU: the wrappers take
    their plain versions; K1's and K2's launches are counted where the
    wrappers would count them."""
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq, pq_adc
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    crops, scores = ops.warp_align_crops, pq.adc_candidates

    def counted_crops(*a, **k):
        wa.launches += 1
        return crops(*a, **k)

    def counted_scores(*a, **k):
        pq_adc.launches += 1
        return scores(*a, **k)

    monkeypatch.setattr(ops, "warp_align_crops", counted_crops)
    monkeypatch.setattr(pq, "adc_candidates", counted_scores)
    monkeypatch.setattr(chip_smoke, "FACADE", dict(
        det="det_500m", rec="w600k_mbf", det_size=(128, 128), max_det=2,
        static=(8, 64, 96), stream=(8, 96, 64),
        oneoff=((60, 80), (97, 131), (300, 100)),
        microbatch=[(60 + 8 * i, 70 + 4 * i) for i in range(6)],
        visits=10, visit_hw=(64, 96), pairs=4))
    monkeypatch.setattr(chip_smoke, "ENGINE_PQ", dict(
        visits=40, idents=12, batches=3, min_train_rows=8))
    said = []
    rep = chip_smoke.Report("CPU")
    monkeypatch.setattr(rep, "say", said.append)
    return rep, said


def test_facade_and_engine_phase_rehearsed_on_the_cpu(monkeypatch):
    """Phase 12: the facade's three routes with K1 counted, the dynamic
    canvases against exact-shape letterboxes, micro-batching against the
    direct path, the clustering engine on the facade, the PQ-tier engine
    run with K2 counted and its decisions equal on both devices (here both
    the CPU), verification's accuracy block."""
    rep, said = _phase12_on_the_cpu(monkeypatch)
    app, fa = chip_smoke.phase_facade(torch, rep)
    assert fa["launches"] == 4             # 2 streamed chunks + 2 buckets
    assert set(fa["routes"]) == {"static (one chunk)",
                                 "two static chunks, streamed",
                                 "dynamic buckets"}
    mb = chip_smoke.phase_microbatch(torch, rep, app)
    assert mb["n_items"] == 6 and 1 <= mb["n_batches"] <= 6
    assert chip_smoke.phase_engine(torch, rep, app)["k1"] > 0
    assert chip_smoke.phase_engine_pq(torch, rep)["k2"] == 2
    ver = chip_smoke.phase_verification(torch, rep, app)
    assert ver["k1"] > 0
    text = "\n".join(said)
    for start in ("facade: get_batch of 19 images", "facade: ms per get_batch",
                  "facade: 3 one-off images' dynamic canvases",
                  "facade: K1 vs plain on the get_batch call's inputs",
                  "microbatch: 6 threads", "engine: SmartFaceEngine",
                  "engine: 'no face' by gate", "engine, PQ tier",
                  "verification: FaceComparison"):
        assert start in text, start
    assert "equal to the CPU run's" in text
    assert "K2 vs plain on the searches' inputs (LUT" in text
    assert fa["err"] == 0.0


def test_phase12_holds_k1_to_its_plain_version_on_the_paths_inputs(
        monkeypatch):
    """The facade's K1 inputs, as phase 12 captures them: the first call
    for each frame-batch shape, cloned before the call; a kernel that
    disagrees with its plain version on them fails the run."""
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rng = np.random.default_rng(0)
    frames = [torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                            dtype=np.uint8))
              for b, h, w in ((2, 40, 60), (2, 40, 60), (1, 64, 64))]
    with chip_smoke.k1_capture() as calls:
        for f in frames:
            minv = torch.from_numpy(chip_smoke.warp_matrices(
                rng, 3, *f.shape[1:3]))
            fidx = torch.tensor([0, 1, 0], dtype=torch.int32) % len(f)
            ops.warp_align_crops(f, minv, fidx)
            minv.fill_(float("nan"))           # the clone kept the input
    assert [tuple(c[0].shape) for c in calls] == [(2, 40, 60, 3),
                                                  (1, 64, 64, 3)]
    assert ops.warp_align_crops is wa.warp_align_crops
    err, what = chip_smoke.k1_on_path(torch, wa, calls)
    assert err == 0.0 and what.startswith("2 calls (3 crops over 2x40x60")
    plain = wa.warp_align_plain
    monkeypatch.setattr(wa, "warp_align_crops",
                        lambda *a, **k: plain(*a, **k) + 0.01)
    with pytest.raises(RuntimeError, match="warp_align: max abs err"):
        chip_smoke.k1_on_path(torch, wa, calls)


def test_phase12_holds_k2_to_its_plain_version_on_the_searches(monkeypatch):
    """The PQ-tier run keeps every search's LUT and codes; a K2 that
    scores them wrong fails the phase, though the exact rerank would
    still decide alike."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc

    rep, _ = _phase12_on_the_cpu(monkeypatch)
    plain = pq_adc.adc_scores_plain
    monkeypatch.setattr(pq_adc, "pq_adc_scores",
                        lambda lut, codes, p: plain(lut, codes, p) * 1.01)
    with pytest.raises(RuntimeError, match="pq_adc .*max abs err"):
        chip_smoke.phase_engine_pq(torch, rep)


def test_phase12_holds_the_fused_topk_to_the_chain_on_the_searches(
        monkeypatch):
    """Every PQ-tier search's inputs, as phase 12 captures them: a fused
    top-k that ranks two tied rows the other way round fails the phase."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc

    rep, _ = _phase12_on_the_cpu(monkeypatch)
    fused = pq_adc.pq_adc_topk

    def swapped(*a, **k):
        s, i = fused(*a, **k)
        return s, i.flip(-1)

    monkeypatch.setattr(pq_adc, "pq_adc_topk", swapped)
    with pytest.raises(RuntimeError, match=r"engine on the PQ tier: the "
                                           r"fused top-k \(hi, k=32\)"):
        chip_smoke.phase_engine_pq(torch, rep)


def test_phase12_fails_on_an_error_the_engine_absorbs(monkeypatch):
    """The engine counts a visit whose decision raised as "no face" and
    logs it at ERROR; phase 12 fails on that record."""
    from scrfd_arcface_facerecognition_tpu_torch.apps import clustering

    rep, _ = _phase12_on_the_cpu(monkeypatch)

    def broken(self, *a, **k):
        raise KeyError("gallery row")

    monkeypatch.setattr(clustering.SmartFaceEngine, "_decide_visit", broken)
    with pytest.raises(RuntimeError, match="logged 40 error.*gallery row"):
        chip_smoke.phase_engine_pq(torch, rep)


def test_no_face_split_names_each_gate():
    import logging

    def rec(msg):
        return logging.LogRecord("x", logging.INFO, "f", 1, msg, None, None)

    records = [rec("face confidence too low in: %s"),
               rec("side face rejected in: %s"),
               rec("side face rejected in: %s"), rec("something else")]
    assert chip_smoke.no_face_split(records, 5) == {
        "confidence": 1, "side face": 2, "no face detected": 2}


def test_phase12_fails_when_the_engine_decides_differently(monkeypatch):
    """The PQ-tier check compares the two runs' records: an engine that
    decides differently on the card fails the phase."""
    rep, _ = _phase12_on_the_cpu(monkeypatch)
    runs = []
    record = chip_smoke.engine_record

    def second_run_differs(engine):
        rec = record(engine)
        runs.append(1)
        if len(runs) == 2:
            rec["db"]["person_visits"][0]["similarity"] += 1e-3
        return rec

    monkeypatch.setattr(chip_smoke, "engine_record", second_run_differs)
    with pytest.raises(RuntimeError, match="decide differently"):
        chip_smoke.phase_engine_pq(torch, rep)


def test_record_diff_holds_floats_to_the_tolerance():
    a = {"x": [1, 0.5, "Person_c_<t>"], "y": {"z": None}}
    assert chip_smoke.record_diff(a, {"x": [1, 0.5 + 1e-6, "Person_c_<t>"],
                                      "y": {"z": None}}, 1e-5) is None
    assert "record['x'][1]" in chip_smoke.record_diff(
        a, {"x": [1, 0.51, "Person_c_<t>"], "y": {"z": None}}, 1e-5)
    assert "length" in chip_smoke.record_diff([1], [1, 2], 0)
    assert "keys" in chip_smoke.record_diff({"a": 1}, {"b": 1}, 0)
    assert chip_smoke.without_clock(
        {"name": "Person_cust_3_1792209646", "created_at": "2026-01-01",
         "rows": [{"last_seen": 1, "v": 2}]}) == {
        "name": "Person_cust_3_<t>", "rows": [{"v": 2}]}


def test_identity_app_gives_the_fake_stacks_faces():
    """chip_smoke's IdentityApp (it may not import tests/fake_stack.py,
    which imports JAX) reads the same identities and gives the same
    faces as tests/fake_stack.FakeFaceAnalysis."""
    from fake_stack import FakeFaceAnalysis, make_image

    images = [make_image(i, jitter=j) for i in (1, 5, 200) for j in (0, 2)]
    assert all(np.array_equal(chip_smoke.identity_image(i, j), im)
               for (i, j), im in zip([(i, j) for i in (1, 5, 200)
                                      for j in (0, 2)], images))
    want = FakeFaceAnalysis().get_batch(images)
    got = chip_smoke.IdentityApp().get_batch(images)
    for w, g in zip(want, got):
        assert len(w) == len(g) == 1
        np.testing.assert_array_equal(g[0].normed_embedding,
                                      w[0].normed_embedding)
        np.testing.assert_array_equal(g[0].bbox, w[0].bbox)
        np.testing.assert_array_equal(g[0].kps, w[0].kps)
        assert g[0].det_score == w[0].det_score


# ------------------------------------------------ phases 13 and 14, rehearsed


class _Event:
    def __init__(self, **kw):
        pass

    def record(self, *a):
        pass

    def elapsed_time(self, other):
        return 0.0

    def synchronize(self):
        pass


def _bf16_phases_on_the_cpu(monkeypatch):
    """Phases 13 and 14 at small sizes on the CPU: the trained det_500m +
    w600k_mbf checkpoints (det_size 128, conf 0.05) in place of the
    full-width stand-ins; K1 counted where the wrapper would count it."""
    from flax import serialization

    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
        Detector, Embedder)

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    crops = ops.warp_align_crops

    def counted(*a, **k):
        wa.launches += 1
        return crops(*a, **k)

    monkeypatch.setattr(ops, "warp_align_crops", counted)
    ckpt = os.path.join(_REPO, "checkpoints", "decisions")
    trees = {}
    for name in ("det_500m", "w600k_mbf"):
        with open(os.path.join(ckpt, name + ".msgpack"), "rb") as f:
            trees[name] = serialization.msgpack_restore(f.read())

    def parts(torch_, dtype, **det_kw):
        det_kw.update(conf_thres=0.05)
        return (Detector("det_500m", variables=trees["det_500m"],
                         input_size=(128, 128), dtype=dtype, device="cpu",
                         **det_kw),
                Embedder("w600k_mbf", variables=trees["w600k_mbf"],
                         dtype=dtype, device="cpu"))

    monkeypatch.setattr(chip_smoke, "standin_parts", parts)
    monkeypatch.setattr(chip_smoke, "BENCH", dict(
        frames=2, hw=(72, 96), depth=3, depths=(1,), fed_depths=(1, 3),
        rounds=1, max_num=2, gallery=4, conf=0.5, pre_nms=32, max_det=4))
    monkeypatch.setattr(chip_smoke, "REALTIME", dict(
        frames=7, hw=(72, 96), batch=3, faces=2, rounds=1, pre_nms=32,
        max_det=4))
    said = []
    rep = chip_smoke.Report("CPU")
    monkeypatch.setattr(rep, "say", said.append)
    return rep, said


def test_bf16_bench_phase_rehearsed_on_the_cpu(monkeypatch, capsys):
    """Phase 13: the stream at each depth, resident and numpy-fed, the
    stage splits, bf16 against f32, K1 on the path's inputs, and the
    bench_bf16 line."""
    import json

    rep, said = _bf16_phases_on_the_cpu(monkeypatch)
    bf = chip_smoke.phase_bf16_bench(torch, rep)
    assert bf["launches"] > 0 and bf["err"] == 0.0
    bench = bf["bench"]
    assert bench["depth"] == 3 and bench["batch"] == 2
    assert set(bench["by_depth"]) == {"1", "3"}
    assert set(bench["numpy_fed_by_depth"]) == {"1", "3"}
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"bench_bf16"')]
    assert len(line) == 1 and json.loads(line[0])["bench_bf16"]["card"] == "CPU"
    text = "\n".join(said)
    for start in ("bf16 bench path: frames/s", "frames fed from numpy",
                  "one call by stage", "bf16 vs f32 on the same",
                  "K1 vs plain on the path's inputs"):
        assert start in text, start


def test_realtime_phase_rehearsed_on_the_cpu(monkeypatch):
    """Phase 14: every frame through the app in order, each batch equal
    to a direct call, K1 counted and held to its plain version; the app's
    replaceable functions restored after it."""
    from scrfd_arcface_facerecognition_tpu_torch.apps import realtime

    before = (realtime.FacePipeline, realtime.open_capture,
              realtime.open_writer, realtime.annotate_batch,
              realtime.read_image)
    rep, said = _bf16_phases_on_the_cpu(monkeypatch)
    rt = chip_smoke.phase_realtime(torch, rep)
    assert rt["launches"] > 0 and rt["err"] == 0.0
    assert (realtime.FacePipeline, realtime.open_capture,
            realtime.open_writer, realtime.annotate_batch,
            realtime.read_image) == before
    text = "\n".join(said)
    assert "every frame written in order" in text and "[3, 3, 1]" in text
    assert "numpy-fed process_stream" in text


def test_phases_13_and_14_fail_on_a_wrong_k1(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    rep, _ = _bf16_phases_on_the_cpu(monkeypatch)
    plain = wa.warp_align_plain
    monkeypatch.setattr(wa, "warp_align_crops",
                        lambda *a, **k: plain(*a, **k) + 0.01)
    with pytest.raises(RuntimeError, match="warp_align: max abs err"):
        chip_smoke.phase_bf16_bench(torch, rep)
    with pytest.raises(RuntimeError, match="warp_align: max abs err"):
        chip_smoke.phase_realtime(torch, rep)


def test_phases_13_and_14_fail_on_an_output_mismatch(monkeypatch):
    """A bf16 path that drifts from f32 fails phase 13; a stream whose
    output differs from a direct call fails phase 14."""
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
        face_pipeline)

    rep, _ = _bf16_phases_on_the_cpu(monkeypatch)
    parts = chip_smoke.standin_parts

    def drifting(torch_, dtype, **kw):
        det, emb = parts(torch_, dtype, **kw)
        if dtype == torch.bfloat16:      # another embedder: unrelated rows
            from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
                Embedder)
            emb = Embedder("w600k_mbf", dtype=dtype, seed=5, device="cpu")
        return det, emb

    monkeypatch.setattr(chip_smoke, "standin_parts", drifting)
    with pytest.raises(RuntimeError, match="bf16 and f32 disagree"):
        chip_smoke.phase_bf16_bench(torch, rep)
    monkeypatch.setattr(chip_smoke, "standin_parts", parts)
    stream = face_pipeline.FacePipeline.process_stream

    def shifted(self, *a, **k):
        for out in stream(self, *a, **k):
            yield out._replace(match_idx=out.match_idx + 1)

    monkeypatch.setattr(face_pipeline.FacePipeline, "process_stream", shifted)
    with pytest.raises(RuntimeError, match="match_idx differs"):
        chip_smoke.phase_realtime(torch, rep)


def test_phase12_engine_fails_when_no_visit_reaches_the_gallery(monkeypatch):
    """Counters that add up are not enough: a run in which every visit
    ends as "no face" took no decision on a model embedding, and fails."""
    import types

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "FACADE", dict(visits=4,
                                                   visit_hw=(64, 96)))

    def no_faces(tmp, app, loader, visits, batches, device, **vdb):
        from scrfd_arcface_facerecognition_tpu_torch.ops import (
            warp_align as wa)

        wa.launches += 1
        out = os.path.join(tmp, "results")
        os.makedirs(out)
        eng = types.SimpleNamespace(
            json_storage=types.SimpleNamespace(output_dir=out))
        return eng, dict(new_persons=0, recognized=0, duplicate_faces=0,
                         no_faces=4, low_quality=0, download_failed=0)

    monkeypatch.setattr(chip_smoke, "run_engine", no_faces)
    rep = chip_smoke.Report("CPU")
    monkeypatch.setattr(rep, "say", lambda msg: None)
    with pytest.raises(RuntimeError, match="engine: K1 launches 1"):
        chip_smoke.phase_engine(torch, rep, None)


def _checkpoints_on_the_cpu(monkeypatch, spoil=None):
    """Phase 13b with the CPU on both sides; ``spoil`` edits the second
    pipeline built (the card's bf16 one) before the phase uses it."""
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "CKPT", dict(chip_smoke.CKPT,
                                                 frames=(6, 240, 320)))
    build = chip_smoke.checkpoint_pipe
    made = []

    def pipe(torch_, dtype, device):
        made.append(dtype)
        if len(made) == 2 and spoil is not None:
            return spoil(build, dtype, device)
        return build(torch_, dtype, device)

    monkeypatch.setattr(chip_smoke, "checkpoint_pipe", pipe)
    said = []
    rep = chip_smoke.Report("CPU")
    monkeypatch.setattr(rep, "say", said.append)
    return rep, said, made


def test_bf16_checkpoints_phase_rehearsed_on_the_cpu(monkeypatch):
    """Phase 13b: the trained checkpoints at bf16, read without Flax, the
    head outputs within the bf16 budget, bf16 apart from f32, the
    pipeline's faces paired and held end to end."""
    rep, said, made = _checkpoints_on_the_cpu(monkeypatch)
    res = chip_smoke.phase_bf16_checkpoints(torch, rep)
    assert made == [torch.bfloat16, torch.bfloat16, torch.float32]
    assert res["pairs"] > 0 and res["lone"] <= 2 and res["cos"] >= 0.999
    assert min(res["apart"].values()) >= 0.5
    assert "card vs CPU: head outputs on one canvas" in said[0]


def test_bf16_checkpoints_phase_fails_on_a_card_that_stays_f32(monkeypatch):
    rep, _, _ = _checkpoints_on_the_cpu(
        monkeypatch, spoil=lambda build, dtype, device: build(
            torch, torch.float32, device))
    with pytest.raises(RuntimeError, match="did not round to bf16"):
        chip_smoke.phase_bf16_checkpoints(torch, rep)


def test_bf16_checkpoints_phase_fails_on_a_wrong_bf16_detector(monkeypatch):
    """A detector whose BatchNorm goes wrong at bf16 (its variances 5 %
    off) leaves the head outputs past the budget."""
    def spoil(build, dtype, device):
        p = build(torch, dtype, device)
        for m in p.detector.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.mul_(1.05)
        return p

    rep, _, _ = _checkpoints_on_the_cpu(monkeypatch, spoil=spoil)
    with pytest.raises(RuntimeError, match="past the bf16 budget"):
        chip_smoke.phase_bf16_checkpoints(torch, rep)


# ------------------------------------------------------ phase 15, rehearsed


def _onnx_phase_on_the_cpu(monkeypatch, tmp_path):
    """Phase 15 at small sizes on the CPU: small exported stand-ins (the
    detector calibrated, the embedder 512 wide) in place of phase 11's
    full-width files, the native models loaded from them by the importer;
    K1 counted where the wrapper would count it."""
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.models.config_from_graph import (
        variables_from_onnx)
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import (
        Detector, Embedder)
    from torch_export import (TorchIResNet, TorchSCRFD, calibrate_detector,
                              export_onnx, seeded)

    paths = {"det_10g": str(tmp_path / "det.onnx"),
             "w600k_r50": str(tmp_path / "rec.onnx")}
    export_onnx(calibrate_detector(seeded(TorchSCRFD(
        stem=8, blocks=(1, 1, 1, 1), planes=(8, 8, 16, 16), neck=8,
        head_feat=16, head_stacks=1), 0)), torch.randn(1, 3, 640, 640),
        paths["det_10g"])
    export_onnx(seeded(TorchIResNet(blocks=(1, 1, 1, 1),
                                    planes=(8, 8, 16, 16)), 0),
                torch.randn(1, 3, 112, 112), paths["w600k_r50"])
    det_cv = variables_from_onnx(paths["det_10g"])
    rec_cv = variables_from_onnx(paths["w600k_r50"])

    def parts(torch_, dtype, **det_kw):
        return (Detector(config=det_cv[0], variables=det_cv[1], dtype=dtype,
                         device="cpu", **det_kw),
                Embedder(config=rec_cv[0], variables=rec_cv[1], dtype=dtype,
                         device="cpu"))

    rep, said = _no_card(monkeypatch, wa)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    crops = ops.warp_align_crops

    def counted(*a, **k):
        wa.launches += 1
        return crops(*a, **k)

    monkeypatch.setattr(ops, "warp_align_crops", counted)
    monkeypatch.setattr(chip_smoke, "standin_onnx", lambda torch_, b: paths)
    monkeypatch.setattr(chip_smoke, "standin_parts", parts)
    small = dict(max_num=3, gallery=4, conf=0.5, pre_nms=32, max_det=4)
    monkeypatch.setattr(chip_smoke, "STANDIN", dict(frames=2, hw=(120, 160),
                                                    **small))
    monkeypatch.setattr(chip_smoke, "BENCH", dict(frames=2, hw=(120, 160),
                                                  depth=2, rounds=1, **small))
    monkeypatch.setattr(chip_smoke, "FACADE", dict(
        chip_smoke.FACADE, static=(2, 120, 160), det_size=(128, 128),
        max_det=4))
    monkeypatch.setattr(chip_smoke, "ONNX_EXEC", dict(
        det_canvases=(1, 2), rec_crops=(2, 3), canvas=(64, 96),
        realtime=(5, 2)))
    return rep, said


def test_onnx_executor_phase_rehearsed_on_the_cpu(monkeypatch, tmp_path):
    """Phase 15: card (here the CPU) against the CPU and against the
    native models within the f32 budget, the per-forward costs, bench.py's
    settings at bf16, K1 counted on the bench rounds and held on the
    phase's inputs, the facade and the realtime app on the files; the
    app's replaceable functions restored after it."""
    from scrfd_arcface_facerecognition_tpu_torch.apps import realtime

    before = (realtime.FacePipeline, realtime.open_capture,
              realtime.open_writer, realtime.annotate_batch,
              realtime.read_image)
    rep, said = _onnx_phase_on_the_cpu(monkeypatch, tmp_path)
    ox = chip_smoke.phase_onnx_exec(torch, rep, {"frames_per_sec": 1.0})
    assert ox["launches"] == 2 and ox["err"] == 0.0     # 1 round x depth 2
    assert all(v <= 1 for v in ox["heads"].values())
    assert len(ox["costs"]) == 8
    assert (realtime.FacePipeline, realtime.open_capture,
            realtime.open_writer, realtime.annotate_batch,
            realtime.read_image) == before
    text = "\n".join(said)
    for start in ("card vs CPU (f32, TF32 off)", "vs the native models",
                  "per forward at bf16", "not checked on the CPU",
                  "onnx executor bench path", "the native models in phase "
                  "13 of this run 1.00", "K1 vs plain on the phase's inputs",
                  "5 frames written in order"):
        assert start in text, start


def test_onnx_executor_phase_fails_on_a_drifting_graph(monkeypatch,
                                                       tmp_path):
    """A card executor whose box distances stray by 1e-3 of their size
    fails (a), before anything is timed."""
    rep, _ = _onnx_phase_on_the_cpu(monkeypatch, tmp_path)
    make = chip_smoke.executor_pipe
    made = []

    def drifting(torch_, paths, dtype, device, **kw):
        pipe = make(torch_, paths, dtype, device, **kw)
        made.append(pipe)
        if len(made) == 2:                # the card's (phase 15a)
            graph = pipe.detector.model.model
            run = graph.forward
            graph.forward = lambda x: [o * 1.001 if i in (3, 4, 5) else o
                                       for i, o in enumerate(run(x))]
        return pipe

    monkeypatch.setattr(chip_smoke, "executor_pipe", drifting)
    with pytest.raises(RuntimeError, match="executor card vs CPU"):
        chip_smoke.phase_onnx_exec(torch, rep, {"frames_per_sec": 1.0})


def test_f32_face_pairing_names_ties_and_fails_the_rest():
    """Phase 15's pairing at the f32 budget: a pair within it passes; two
    overlapping faces of near-equal score that NMS kept one way on each
    side are an order tie; a face on one side only that ties nothing, or
    a pair past the budget, fails."""
    from scrfd_arcface_facerecognition_tpu_torch.pipeline.face_pipeline import (
        PipelineOutput)

    def out(boxes, scores):
        n = len(boxes)
        emb = np.zeros((1, 3, 512), np.float32)
        emb[0, :, 0] = 1
        valid = np.arange(3) < n
        b = np.zeros((1, 3, 4), np.float32)
        b[0, :n] = boxes
        s = np.zeros((1, 3), np.float32)
        s[0, :n] = scores
        return PipelineOutput(*(torch.from_numpy(a) for a in (
            b, s, np.zeros((1, 3, 5, 2), np.float32), valid[None],
            np.asarray([n], np.int32), emb,
            np.full((1, 3), -1, np.int32), np.zeros((1, 3), np.float32))))

    kw = dict(conf=0.5, cuts=[(0.2,)], iou_thres=0.4, sim=0.4, where="t")
    a = [[0, 0, 100, 100], [300, 300, 400, 400]]
    share, n, lone = chip_smoke.hold_f32_faces(
        torch, out(a, [0.9, 0.8]), out([[0, 0, 100.005, 100], a[1]],
                                       [0.90005, 0.8]), **kw)
    assert n == 2 and lone == 0 and 0 < share["px"] <= 1
    # an order tie: the second face kept one way on each side
    share, n, lone = chip_smoke.hold_f32_faces(
        torch, out(a, [0.9, 0.8]),
        out([a[0], [310, 310, 410, 410]], [0.9, 0.8001]), **kw)
    assert n == 1 and lone == 2
    with pytest.raises(RuntimeError, match="no tie"):
        chip_smoke.hold_f32_faces(torch, out(a, [0.9, 0.8]),
                                  out([a[0]], [0.9]), **kw)
    with pytest.raises(RuntimeError, match="shares of the f32 budget"):
        chip_smoke.hold_f32_faces(torch, out(a, [0.9, 0.8]),
                                  out(a, [0.9, 0.81]), **kw)


def _camera_apps_on_the_cpu(monkeypatch, tmp_path):
    """Phase 16 at small sizes on the CPU: phase 15's small exported
    stand-ins as the weight files, small cameras."""
    rep, said = _onnx_phase_on_the_cpu(monkeypatch, tmp_path)
    monkeypatch.setattr(chip_smoke, "CAMERAS", dict(
        hd=(48, 64), sd=(32, 48), frames=6, dual_pairs=4, workers=2,
        slot_bytes=48 * 64 * 3))
    return rep, said, chip_smoke.standin_onnx(torch, None)


def test_camera_apps_phase_rehearsed_on_the_cpu(monkeypatch, tmp_path):
    """Phase 16: the multi-camera app through decode threads and through
    the decode pool (the cameras opened in the workers), every live
    camera's frames written in order at its own size, each round equal to
    a direct call, the same rounds from both readers; the dual app with
    its second camera resized; K1 counted and held on the runs' inputs;
    the apps' replaceable names and the pool class restored after it."""
    from scrfd_arcface_facerecognition_tpu_torch.apps import realtime
    from scrfd_arcface_facerecognition_tpu_torch.runtime import decode_pool

    before = (realtime.FacePipeline, realtime.open_capture,
              realtime.open_writer, realtime.annotate_batch,
              realtime.read_image, decode_pool.DecodePool)
    rep, said, paths = _camera_apps_on_the_cpu(monkeypatch, tmp_path)
    cam = chip_smoke.phase_camera_apps(torch, rep, paths)
    # 6 rounds a reader (4 streams for 3 frames, then 3 for 3), 4 pairs,
    # and each run's gallery photo
    assert cam["launches"] == 6 + 6 + 4 + 3 and cam["err"] == 0.0
    assert cam["start_s"] > 0 and cam["first_round_s"] > 0
    assert (realtime.FacePipeline, realtime.open_capture,
            realtime.open_writer, realtime.annotate_batch,
            realtime.read_image, decode_pool.DecodePool) == before
    text = "\n".join(said)
    for start in ("camera apps: multistream.run (threads)",
                  "camera apps: multistream.run (pool)",
                  "4 synthetic cameras and one that does not open",
                  "in 6 rounds of [3, 4] streams",
                  "the same rounds as the decode threads",
                  "camera apps: dualstream.run", "4 pairs"):
        assert start in text, start


def test_camera_apps_phase_fails_on_a_frame_out_of_order(monkeypatch,
                                                         tmp_path):
    """A camera whose frames reach the writer out of order fails phase
    16."""
    rep, _, paths = _camera_apps_on_the_cpu(monkeypatch, tmp_path)
    real = chip_smoke.SyntheticCapture.read

    def swapped(self):
        ok, frame = real(self)
        if ok and len(self.sums) == 2 and self.h == 48:
            frame = self.frames[2].copy()      # frame 2 in frame 1's place
        return ok, frame

    monkeypatch.setattr(chip_smoke.SyntheticCapture, "read", swapped)
    with pytest.raises(RuntimeError, match=r"camera apps \(threads\): "
                                           r"stream 0 written"):
        chip_smoke.phase_camera_apps(torch, rep, paths)


def test_synthetic_cameras_cover_the_phases_cases():
    cams = chip_smoke.camera_sources()
    hd, sd, n = (chip_smoke.CAMERAS[k] for k in ("hd", "sd", "frames"))
    assert [(k, (h, w)) for _, k, h, w in cams] == [
        (n, hd), (n // 2, hd), (0, (0, 0)), (n, sd), (n, hd)]
    down = chip_smoke.synthetic_camera("cam:down")
    assert not down.isOpened() and down.read() == (False, None)
    cap = chip_smoke.synthetic_camera(cams[3][0])
    assert cap.get(3) == sd[1] and cap.get(4) == sd[0] and cap.fps == 25.0


def test_web_phase_rehearsed_on_the_cpu(monkeypatch):
    """Phase 17: the engine over HTTP equal to the engine driven
    directly, every other route answered, concurrent comparisons
    coalesced and equal to the sequential ones, the PQ tier through the
    web with K2 counted and held, its decisions equal to the CPU run's;
    the web app's reader and encoder restored after it."""
    from scrfd_arcface_facerecognition_tpu_torch.apps import webapp

    before = (webapp.read_image, webapp.encode_jpeg)
    rep, said = _phase12_on_the_cpu(monkeypatch)
    app, _ = chip_smoke.phase_facade(torch, rep)
    web = chip_smoke.phase_web(torch, rep, app, dict(ms_visit=1.0,
                                                     ms_pair=2.0))
    assert web["k1"] > 0 and web["k2"] == 2 and web["width"] > 1
    assert web["err1"] == 0.0 and web["err2"] == 0.0
    assert (webapp.read_image, webapp.encode_jpeg) == before
    assert app._microbatcher is None
    text = "\n".join(said)
    for start in ("web API: make_server on 127.0.0.1",
                  "(phase 12 direct 1.00)", "(phase 12 direct 2.00)",
                  "GET /api/image-base64/{path} 200",
                  "POST /api/process-visits-from-api 400",
                  "POST /api/clear-database 200",
                  "web API: serving.microbatch on",
                  "web API, PQ tier: IdentityApp",
                  "the decisions equal to the CPU run's"):
        assert start in text, start


def test_web_phase_fails_on_an_error_a_handler_logs(monkeypatch):
    """A route whose handler raises answers 500 and logs at ERROR; phase
    17 fails on either."""
    from scrfd_arcface_facerecognition_tpu_torch.apps import clustering

    rep, _ = _phase12_on_the_cpu(monkeypatch)
    app, _ = chip_smoke.phase_facade(torch, rep)
    monkeypatch.setattr(clustering.SmartFaceEngine, "get_low_similarity_"
                        "images", lambda self: 1 / 0)
    with pytest.raises(RuntimeError, match="web API: (routes answered "
                                           "{'GET /api/low-similarity|the "
                                           "port logged)"):
        chip_smoke.phase_web(torch, rep, app, dict(ms_visit=1.0,
                                                   ms_pair=2.0))


def _train_phase_on_the_cpu(monkeypatch):
    """Phase 18 at small sizes on the CPU: tiny MobileFaceNet / iResNet in
    place of w600k_mbf / w600k_r50 (the embedder 512 wide), the CLIs run
    in this process, a tiny seeded detector in place of the det_10g
    stand-in; K1 counted where the wrapper would count it."""
    import contextlib
    import importlib
    import io

    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.models import arcface as TA
    from scrfd_arcface_facerecognition_tpu_torch.models import scrfd as TS
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.pipeline import Detector

    class Event(_Event):
        def elapsed_time(self, other):
            return 1.0

    rep, said = _no_card(monkeypatch, wa)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setitem(TA.ARCFACE_CONFIGS, "w600k_mbf", TA.ArcFaceConfig(
        name="w600k_mbf", arch="mobilefacenet", mbf_blocks=(1, 1, 1, 1),
        mbf_scale=1))
    monkeypatch.setitem(TA.ARCFACE_CONFIGS, "w600k_r50", TA.ArcFaceConfig(
        name="w600k_r50", arch="iresnet", stage_blocks=(1, 1, 1, 1),
        stage_filters=(8, 8, 16, 16)))
    monkeypatch.setattr(chip_smoke, "TRAIN", dict(
        cmp=dict(rec="w600k_mbf", batch=4, classes=20, steps=2, rate=0.5),
        full=dict(rec="w600k_r50", batch=4, classes=1000, rate=0.1, warm=1,
                  timed=1),
        learn=dict(rec="w600k_mbf", batch=8, classes=8, steps=6, lr=0.1),
        loop=dict(rec="w600k_mbf", steps=1, batch=2, crops=3, frames=2,
                  hw=(120, 160), calls=1)))
    small = dict(max_num=3, gallery=4, conf=0.0, pre_nms=32, max_det=4)
    monkeypatch.setattr(chip_smoke, "STANDIN", dict(frames=2, hw=(120, 160),
                                                    **small))
    tiny_det = TS.SCRFDConfig("det_10g", 8, (1, 1, 1, 1), (8, 8, 16, 16),
                              neck_filters=8, head_stacks=1, head_filters=16)
    monkeypatch.setattr(chip_smoke, "standin_parts", lambda torch_, dtype,
                        **kw: (Detector(config=tiny_det, dtype=dtype,
                                        device="cpu", **kw), None))

    def in_process(torch_, module, args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            importlib.import_module(module).main(list(args))
        return buf.getvalue().splitlines()

    monkeypatch.setattr(chip_smoke, "run_cli", in_process)
    crops = ops.warp_align_crops

    def counted(*a, **k):
        wa.launches += 1
        return crops(*a, **k)

    monkeypatch.setattr(ops, "warp_align_crops", counted)
    return rep, said


def test_train_phase_rehearsed_on_the_cpu(monkeypatch, tmp_path):
    """Phase 18: card (here the CPU) against the CPU within the stated
    tolerances on both softmaxes, the full-width step timed with and
    without remat, one batch memorized, the CLIs' checkpoint exported,
    read back bit-equal and served through the pipeline with K1 counted
    and held; TF32's settings left as they were."""
    monkeypatch.chdir(tmp_path)
    before = _tf32()
    rep, said = _train_phase_on_the_cpu(monkeypatch)
    out = chip_smoke.phase_train(torch, rep)
    assert _tf32() == before
    assert out["launches"] > 0 and out["err"] == 0.0
    assert set(out["cmp"]) == {"full softmax", "Partial FC 0.5"}
    for r in out["cmp"].values():                  # CPU against itself
        assert r["loss32"][0] == r["loss32"][1] and r["rel64"] == 0.0
        for gaps in r["gaps"]:
            assert set(gaps) == {"weights", "BN statistics", "momentum"}
            assert all(share == 0.0 for share, _ in gaps.values())
    assert set(out["full"]) == {False, True, "busy"}
    assert out["full"]["busy"] is None           # no profile off the card
    assert out["learn"][-1] < out["learn"][0]
    text = "\n".join(said)
    for start in ("train card vs CPU (w600k_mbf full width, batch 4",
                  "remat on:", "remat off:", "remat costs",
                  "one fixed batch of 8 images", "train -> export:",
                  "bit-equal to load_inference_variables(checkpoint)",
                  "train -> serve: FacePipeline", "phase 18 took"):
        assert start in text, start


def test_train_phase_fails_past_the_bound():
    """A tensor past ``atol + rtol * max`` fails the phase with its name;
    within it, the largest share of each kind and its tensor come back."""
    want = {"backbone": {"w": torch.ones(4, dtype=torch.float64),
                         "bn.running_var": torch.ones(2, dtype=torch.float64)},
            "head_w": torch.ones(2, 3, dtype=torch.float64),
            "trace": {"w": torch.zeros(4, dtype=torch.float64),
                      "head_w": torch.zeros(2, 3, dtype=torch.float64)}}
    got = {"backbone": {k: v.clone() for k, v in want["backbone"].items()},
           "head_w": want["head_w"] + 5e-11,
           "trace": {k: v.clone() for k, v in want["trace"].items()}}
    out = chip_smoke.worst_gaps(got, want, "x")
    share, name = out["weights"]
    assert name == "head_w"
    assert share == pytest.approx(5e-11 / (1e-12 + 1e-10), rel=1e-3)
    assert out["BN statistics"] == (0.0, "backbone.bn.running_var")
    assert out["momentum"][0] == 0.0
    got["trace"]["head_w"][1, 2] = 2e-12
    with pytest.raises(RuntimeError, match="x trace.head_w: 2 x"):
        chip_smoke.worst_gaps(got, want, "x")


def test_train_phase_fails_on_learned_random_labels(monkeypatch, tmp_path):
    """Phase 18b's losses come from fresh random labels: a step whose loss
    drops below ln(sampled classes) / 2 fails the phase."""
    from scrfd_arcface_facerecognition_tpu_torch import train as TT

    monkeypatch.chdir(tmp_path)
    rep, _ = _train_phase_on_the_cpu(monkeypatch)
    step = TT.ArcFaceTrainer.train_step

    def learned(self, *a, **k):
        state, loss = step(self, *a, **k)
        return state, loss * 0.0 + 1.0
    monkeypatch.setattr(TT.ArcFaceTrainer, "train_step", learned)
    with pytest.raises(RuntimeError, match=r"below ln\(100\) / 2"):
        chip_smoke.phase_train_full(torch, rep)


# ------------------------------------------------------ phase 19, rehearsed


def _det_phase_on_the_cpu(monkeypatch, tmp_path):
    """Phase 19 at small sizes on the CPU: a tiny SCRFD in place of
    det_500m and det_10g (128 x 128 for (a)-(c); (d) at the 640 x 640 that
    ``FacePipeline(det_onnx=)`` letterboxes to), the CLIs run in this
    process, a small exported iResNet stand-in (512 wide) in place of
    phase 11's w600k_r50 file; K1 counted where the wrapper would count
    it."""
    import contextlib
    import dataclasses
    import importlib
    import io

    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.models import scrfd as TS
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from torch_export import TorchIResNet, export_onnx, seeded

    class Event(_Event):
        def elapsed_time(self, other):
            return 1.0

    rep, said = _no_card(monkeypatch, wa)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    for name in ("empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    tiny = TS.SCRFDConfig("det_500m", 8, (1, 1, 1, 1), (8, 8, 16, 16),
                          neck_filters=8, head_stacks=1, head_filters=16)
    monkeypatch.setitem(TS.SCRFD_CONFIGS, "det_500m", tiny)
    monkeypatch.setitem(TS.SCRFD_CONFIGS, "det_10g",
                        dataclasses.replace(tiny, name="det_10g"))
    monkeypatch.setattr(chip_smoke, "TRAIN_DET", dict(
        cmp=dict(det="det_500m", size=128, batch=2, max_gt=3, steps=2),
        full=dict(det="det_10g", size=128, batch=2, max_gt=4, warm=1,
                  timed=1),
        learn=dict(det="det_500m", size=128, batch=2, max_gt=3, steps=8,
                   lr=0.01),
        loop=dict(det="det_500m", size=640, images=6, batch=4, max_gt=4,
                  passes=2, lr=0.01, cli_steps=1, frames=2, hw=(120, 160),
                  calls=1, conf_ranks=(2, 8))))
    monkeypatch.setattr(chip_smoke, "STANDIN", dict(
        frames=2, hw=(120, 160), max_num=3, gallery=4, conf=0.5, pre_nms=32,
        max_det=4))
    rec = str(tmp_path / "rec.onnx")
    export_onnx(seeded(TorchIResNet(blocks=(1, 1, 1, 1),
                                    planes=(8, 8, 16, 16)), 0),
                torch.randn(1, 3, 112, 112), rec)
    monkeypatch.setattr(chip_smoke, "standin_onnx",
                        lambda torch_, b: {"w600k_r50": rec})

    def in_process(torch_, module, args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            importlib.import_module(module).main(list(args))
        return buf.getvalue().splitlines()

    monkeypatch.setattr(chip_smoke, "run_cli", in_process)
    crops = ops.warp_align_crops

    def counted(*a, **k):
        wa.launches += 1
        return crops(*a, **k)

    monkeypatch.setattr(ops, "warp_align_crops", counted)
    return rep, said


def test_det_train_phase_rehearsed_on_the_cpu(monkeypatch, tmp_path):
    """Phase 19: card (here the CPU) against the CPU within the stated
    tolerances, the assignment equal; the det_10g step timed; one batch
    memorized; the labelled set through the data path, training, AP, the
    CLIs, the export read back bit-equal and both pipelines' faces held to
    the f32 budget with K1 counted and held; TF32's settings left as they
    were."""
    monkeypatch.chdir(tmp_path)
    before = _tf32()
    rep, said = _det_phase_on_the_cpu(monkeypatch, tmp_path)
    out = chip_smoke.phase_det_train(torch, rep)
    assert _tf32() == before
    assert out["launches"] > 0 and out["err"] == 0.0 and out["faces"] > 0
    cmp = out["cmp"]                              # the CPU against itself
    assert cmp["loss32"][0] == cmp["loss32"][1] and cmp["rel64"] == 0.0
    assert cmp["worst"] == 0.0 and min(cmp["n_pos"]) > 0
    for gaps in cmp["gaps"]:
        assert set(gaps) == {"weights", "BN statistics", "momentum"}
    assert out["full"]["busy"] is None and out["full"]["spans"] is None
    assert min(out["full"]["n_pos"]) > 0
    assert out["learn"][-1] < out["learn"][0]
    assert 0.0 <= out["ap"] <= 1.0
    assert all(v <= 1 for v in out["share"].values())
    text = "\n".join(said)
    for start in ("det train card vs CPU (det_500m full width, 128x128",
                  "ATSS assignment equal on both devices",
                  "det train det_10g full width", "one fixed batch of 2",
                  "det data -> train: 6 labelled images",
                  "evaluate_detector AP@0.5", "det train -> export:",
                  "bit-equal to load_inference_variables(checkpoint)",
                  "det train -> serve: the trained det_500m",
                  "phase 19 took"):
        assert start in text, start


def test_det_phase_fails_when_k1_warps_no_crop(monkeypatch, tmp_path):
    """A threshold above every anchor's score leaves K1 nothing to warp:
    phase 19d fails."""
    monkeypatch.chdir(tmp_path)
    rep, _ = _det_phase_on_the_cpu(monkeypatch, tmp_path)
    monkeypatch.setattr(chip_smoke, "conf_below_top",
                        lambda torch_, heads, lo, hi: (1.5, 1.0, 1.0))
    with pytest.raises(RuntimeError, match="paired|no crop"):
        chip_smoke.phase_det_loop(torch, rep)


def test_det_labels_parse_back_with_unlabeled_landmarks(tmp_path):
    """Phase 19d's label file and loader: every image parses back with its
    faces, the odd faces' landmarks unlabeled, and the loader draws the
    image at the size its labels were made for."""
    from scrfd_arcface_facerecognition_tpu_torch.train import (
        parse_wider_annotations)

    path = str(tmp_path / "label.txt")
    chip_smoke.det_label_file(path, 5)
    anns = parse_wider_annotations(path)
    assert len(anns) == 5
    for i, a in enumerate(anns):
        (h, w), faces = chip_smoke.det_faces(i)
        assert len(a.boxes) == len(faces)
        assert a.kps_valid.tolist() == [j % 2 == 0 for j in range(len(faces))]
        img = chip_smoke.det_image(a.path)
        assert img.shape == (h, w, 3) and img.dtype == np.uint8
        np.testing.assert_allclose(a.boxes[0, :2], faces[0][0][:2],
                                   atol=0.01)


def test_det_phase_settings_match_the_clis_defaults_at_full_width():
    """Phase 19's settings: (b) times det_10g (the main path's detector)
    at ``tools.train_scrfd``'s own defaults; (a), (c) and (d) train
    det_500m at its full width on 640 x 640 canvases; (d) serves 8 1080p
    frames, the threshold between ranked anchor scores."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import train_scrfd

    d = train_scrfd.parse_args(["--synthetic", "1"])
    c = chip_smoke.TRAIN_DET
    full = c["full"]
    assert (full["det"], full["size"], full["batch"], full["max_gt"]) == (
        chip_smoke.MAIN["det"], d.input_size, d.batch, d.max_gt)
    assert (full["warm"], full["timed"]) == (3, 10)
    assert (c["cmp"]["det"], c["cmp"]["size"], c["cmp"]["batch"],
            c["cmp"]["max_gt"], c["cmp"]["steps"]) == ("det_500m", 640, 4,
                                                       8, 3)
    assert (c["learn"]["batch"], c["learn"]["steps"]) == (4, 30)
    loop = c["loop"]
    assert (loop["images"], loop["frames"], loop["hw"]) == (16, 8,
                                                            (1080, 1920))
    lo, hi = loop["conf_ranks"]
    assert 0 < lo < hi


def _parallel_phase_on_the_cpu(monkeypatch, k1_step=1, k2_step=1):
    """Phase 20 at small sizes on 4 CPU slots: det_500m + w600k_mbf on 8
    frames of 96 x 128, a 20,000-row dense gallery, and phase 7's gallery
    stood in by a small AutoGallery's PQ tier (400 rows of 512); K1 and K2
    counted where the wrappers would count them (``k1_step`` /
    ``k2_step`` launches a call). ``realtime --disagg 1`` meets a machine
    of one card (one CPU slot) in place of the card."""
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.gallery import (
        AutoGallery, pq as tpq, pq_adc)
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.parallel import (
        Slot, disagg)

    rep, said = _no_card(monkeypatch, wa)
    monkeypatch.setattr(chip_smoke, "MAIN", dict(
        chip_smoke.MAIN, det="det_500m", rec="w600k_mbf"))
    monkeypatch.setattr(chip_smoke, "PAR", dict(
        slots=4, dense=(20_000, 6, 5), pq_capacity=1024, k=5,
        auto_min_rows=64, dp=dict(frames=8, hw=(96, 128), max_num=2, gallery=8),
        disagg=dict(batches=2)))
    monkeypatch.setattr(disagg, "card_slots",
                        lambda: [Slot(0, torch.device("cpu"))])
    crops, scores = ops.warp_align_crops, tpq.adc_candidates

    def counted_k1(*a, **k):
        wa.launches += k1_step
        return crops(*a, **k)

    def counted_k2(*a, **k):
        pq_adc.launches += k2_step
        return scores(*a, **k)

    monkeypatch.setattr(ops, "warp_align_crops", counted_k1)
    monkeypatch.setattr(tpq, "adc_candidates", counted_k2)
    rng = np.random.default_rng(0)
    rows, _, _ = chip_smoke.identity_rows(rng, 400, 40, 512, 0.05)
    ag = AutoGallery(vector_size=512, tier="pq", min_train_rows=64,
                     pq_train_iters=2, device="cpu")
    ag.add_batch(np.arange(400), rows)
    gal = dict(pq=ag._pq, queries=rows[:6], rows=rows[:300],
               ids=np.arange(300))
    return rep, said, gal


def test_parallel_phase_rehearsed_on_the_cpu(monkeypatch):
    """Phase 20: the dense and PQ sharded galleries against their
    unsharded counterparts, K2 once a shard a search, the snapshots
    across the mesh, frame DP and both disaggregated placements against
    the pipeline with K1 counted, the one-card realtime refusal, and the
    times beside the single-device ones labelled for slots on one card."""
    rep, said, gal = _parallel_phase_on_the_cpu(monkeypatch)
    before = _tf32()
    out = chip_smoke.phase_parallel(torch, rep, gal)
    assert _tf32() == before
    # two PQGallery searches over 4 shards; the AutoGallery on the mesh,
    # restored unmeshed (1 shard) and restored back onto the mesh
    assert out["k2"] == 2 * 4 + 4 + 1 + 4
    assert out["k1"] > 0 and out["err1"] == 0.0 and out["err2"] == 0.0
    text = "\n".join(said)
    for start in ("phase 20 mesh: 4 slots on one card — not a scaling figure",
                  "20a dense ShardedGallery", "20b sharded PQ",
                  "K2 launched once a shard a search",
                  "20b AutoGallery(tier='pq', mesh=)", "20c frame DP",
                  "20d disagg", "shard_gallery=True (RowShards)",
                  "shard_gallery=auto (dict)",
                  "realtime --disagg 1 on one card raises",
                  "20e per-call ms"):
        assert start in text, start


@pytest.mark.parametrize("k1_step,k2_step,match", [
    (1, 2, "K2 launched 8 times"), (0, 1, "K1 was launched no time")])
def test_parallel_phase_fails_on_a_wrong_launch_count(monkeypatch, k1_step,
                                                      k2_step, match):
    rep, _, gal = _parallel_phase_on_the_cpu(monkeypatch, k1_step, k2_step)
    with pytest.raises(RuntimeError, match=match):
        chip_smoke.phase_parallel(torch, rep, gal)


def _mesh_phase_on_the_cpu(monkeypatch):
    """Phase 21 at small sizes on 4 CPU slots: phase 18's rehearsal (tiny
    embedders 512 wide, a tiny seeded detector for the stand-in, the CLIs
    in this process, K1 counted) with a tiny SCRFD in place of det_500m
    and det_10g."""
    import dataclasses

    from scrfd_arcface_facerecognition_tpu_torch.models import scrfd as TS

    rep, said = _train_phase_on_the_cpu(monkeypatch)
    monkeypatch.setattr(chip_smoke, "run_clis", lambda torch_, calls: [
        chip_smoke.run_cli(torch_, m, a) for m, a in calls])
    tiny = TS.SCRFDConfig("det_500m", 8, (1, 1, 1, 1), (8, 8, 16, 16),
                          neck_filters=8, head_stacks=1, head_filters=16)
    monkeypatch.setitem(TS.SCRFD_CONFIGS, "det_500m", tiny)
    monkeypatch.setitem(TS.SCRFD_CONFIGS, "det_10g",
                        dataclasses.replace(tiny, name="det_10g"))
    monkeypatch.setattr(chip_smoke, "TRAIN_MESH", dict(
        cmp=dict(rec="w600k_mbf", batch=4, classes=21, rate=0.5, steps=2,
                 det="det_500m", size=128, max_gt=3),
        full=dict(rec="w600k_r50", batch=4, classes=1000, rate=0.1,
                  det="det_10g", size=128, det_batch=4, max_gt=4,
                  det_batches=2, warm=1, timed=1),
        serve=dict(rec="w600k_mbf", classes=8, batch=4, steps=1, crops=3,
                   frames=2, hw=(120, 160), calls=1),
        cli=dict(steps=1, rec="w600k_mbf", batch=4, det="det_500m",
                 det_batch=4)))
    return rep, said


def test_train_mesh_phase_rehearsed_on_the_cpu(monkeypatch, tmp_path):
    """Phase 21: both meshes against their one-device trainers within the
    float64 bound (the classes padded, the detector's slots holding
    unequal face counts), the full-width steps timed beside 18b / 19b, a
    mesh-trained checkpoint served with K1 counted and held, both CLIs on
    4 slots; TF32's settings left as they were."""
    monkeypatch.chdir(tmp_path)
    before = _tf32()
    rep, said = _mesh_phase_on_the_cpu(monkeypatch)
    out = chip_smoke.phase_train_mesh(torch, rep, dict(arcface=1.0, det=2.0))
    assert _tf32() == before
    assert out["launches"] > 0 and out["err"] == 0.0
    assert out["cos"] >= chip_smoke.TOL_TRAIN["cos"]
    assert set(out["cmp"]) == {"full softmax", "Partial FC 0.5", "det"}
    for r in out["cmp"].values():
        assert r["rel"] <= chip_smoke.TOL_TRAIN["loss64"]
        for gaps in r["gaps"]:
            assert set(gaps) == {"weights", "BN statistics", "momentum"}
            assert all(share <= 1.0 for share, _ in gaps.values())
    assert min(out["cmp"]["det"]["n_pos"]) > 0
    assert out["full"]["arcface"]["busy"] is None      # no profile off
    text = "\n".join(said)                             # the card
    for start in ("21a ArcFace mesh {'data': 2, 'model': 2}",
                  "21 classes (padded to 22)", "21a detector mesh",
                  "21b ArcFace mesh", "the one-device step of 18b in this "
                  "run 1.000 ms", "21b detector mesh",
                  "the one-device step of 19b in this run 2.000 ms",
                  "one step's host time by span: forward_loss",
                  "21c mesh-trained -> serve", "21d the CLIs",
                  "mesh=data:2xmodel:2", "mesh=data:4", "phase 21 took"):
        assert start in text, start


def _signoff_phase_on_the_cpu(monkeypatch):
    """Phase 22 on the CPU: small torch stand-ins in place of the five
    full-width ones (and of the mutated three), smaller frames of three
    sizes, K1 counted where the wrapper would count it, the gate run in
    this process (its steps still in child processes)."""
    import contextlib
    import importlib
    import io

    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        e2e_oracle as eo, verify_release as vr)

    rep, said = _no_card(monkeypatch, wa)
    real = vr.torch_export

    def small():
        te = real()
        det = dict(stem=8, blocks=(1, 1, 1, 1), planes=(8, 8, 16, 16),
                   neck=16, head_feat=16, head_stacks=1)
        mbf = dict(blocks=(1, 1, 1, 1), scale=1, stem_filters=16,
                   stem_dw_groups=16, stage_filters=(16, 32, 32),
                   down_groups=(16, 32, 32), res_groups=(16, 16, 32, 32),
                   sep_filters=64)
        te.STAND_INS = {
            "det_500m": lambda: te.TorchSCRFD(**det),
            "det_2.5g": lambda: te.TorchSCRFD(**dict(det, head_stacks=2)),
            "det_10g": lambda: te.TorchSCRFD(**dict(
                det, stem=16, planes=(16, 16, 24, 32), head_feat=32)),
            "w600k_mbf": lambda: te.TorchMobileFaceNet(**mbf),
            "w600k_r50": lambda: te.TorchIResNet(blocks=(1, 1, 1, 1),
                                                 planes=(8, 16, 16, 32)),
        }
        te.MUTATED_STAND_INS = {
            "det_10g": lambda: te.TorchSCRFD(**dict(
                det, planes=(8, 16, 24, 32), neck=24, head_feat=32,
                gn_groups=8)),
            "w600k_mbf": lambda: te.TorchMobileFaceNet(**dict(
                mbf, sep_filters=96, stage_filters=(16, 32, 48))),
            "w600k_r50": lambda: te.TorchIResNet(blocks=(1, 2, 1, 1),
                                                 planes=(8, 16, 24, 40)),
        }
        return te

    monkeypatch.setattr(vr, "torch_export", small)
    monkeypatch.setattr(chip_smoke, "SIGNOFF", dict(frames=3, gate_slots=8))
    frames = eo.synthetic_frames
    monkeypatch.setattr(eo, "synthetic_frames", lambda n: frames(
        n, sizes=((120, 160), (180, 320), (270, 480))))
    crops = ops.warp_align_crops

    def counted(*a, **k):
        wa.launches += 1
        return crops(*a, **k)

    monkeypatch.setattr(ops, "warp_align_crops", counted)

    def in_process(torch_, module, args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert importlib.import_module(module).main(list(args)) == 0
        return buf.getvalue().splitlines()

    monkeypatch.setattr(chip_smoke, "run_cli", in_process)
    return rep, said


def test_signoff_phase_rehearsed_on_the_cpu(monkeypatch):
    """Phase 22: both sign-offs PASS row by row (the mutated one on its
    mutated graphs), K1 counted over the e2e stage and 0 u8 from its plain
    version, the truncated file refused with its class, the gate's report
    read back; TF32's settings left as they were."""
    before = _tf32()
    rep, said = _signoff_phase_on_the_cpu(monkeypatch)
    out = chip_smoke.phase_signoff(torch, rep)
    assert _tf32() == before
    assert out["launches"] > 0 and out["err"] == 0.0
    assert [r["mode"] for r in out["runs"]["b"]["rows"]] == [
        "standin", "standin", "mutated", "mutated", "mutated"]
    for run in out["runs"].values():
        assert all(r["passed"] for r in run["rows"]) and len(run["rows"]) == 5
        assert [r["pair"] for r in run["e2e"]] == [
            "det_10g+w600k_r50", "det_500m+w600k_mbf"]
        assert all(r["e2e"]["n_strict"] > 0 for r in run["e2e"])
    assert out["runs"]["a"]["code"] == 0
    text = "\n".join(said)
    for start in ("22a [graph] det_500m | standin", "22a [e2e] det_10g+",
                  "22b [graph] w600k_r50 | mutated", "22b [e2e] det_500m+",
                  "22a 3 seeded synthetic frames", "K1 vs plain on",
                  "22c a det_500m.onnx cut at 3/5", "corrupt_or_truncated",
                  "22d release_check --skip tests signoff mutate",
                  "[gate] overall: PASS", "dryrun_multichip(8) on cpu",
                  "phase 22 took"):
        assert start in text, start
    assert "FAIL" not in text.replace("SIGN-OFF FAIL", "")
    assert "(reported, not required)" in text
    assert "(reported, not required)" not in "\n".join(
        s for s in said if s.startswith("22a"))


def test_signoff_run_reports_the_pairings_it_does_not_require(monkeypatch):
    """(b)'s pairings are printed and not required: a pairing past its
    budget leaves such a run passing, FAIL said on its row; a run that
    requires its pairings fails on it."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        verify_release as vr)

    rep, said = _signoff_phase_on_the_cpu(monkeypatch)
    monkeypatch.setattr(vr, "e2e_passed", lambda w: False)
    argv = ["--weights", "/nonexistent", "--mutate"]
    res, launches, err = chip_smoke.signoff_run(torch, rep, vr, "b", argv,
                                                require_e2e=False)
    assert res["code"] == 1 and launches > 0 and err == 0.0
    assert all(r["passed"] for r in res["rows"])
    assert sum("FAIL (reported, not required)" in s for s in said) == 2
    with pytest.raises(RuntimeError, match="22b the sign-off failed"):
        chip_smoke.hold_signoff(res, "b")


def test_signoff_phase_fails_on_a_graph_past_its_budget(monkeypatch):
    """A sign-off row that fails its budget fails the phase."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        verify_release as vr)

    rep, said = _signoff_phase_on_the_cpu(monkeypatch)
    monkeypatch.setattr(vr, "DET_RAW_BUDGET", 0.0)
    with pytest.raises(RuntimeError, match="22a the sign-off failed"):
        chip_smoke.phase_signoff(torch, rep)
    assert any("| FAIL" in s for s in said)


def _gallery_scale_on_the_cpu(monkeypatch):
    """Phase 23 at small sizes: an 8,000-row PQ gallery, the sweep at Q = 4
    and 8 with K2 held to its plain version at both, a 4,000-row recall
    study, 9,000 codes drawn in place and searched at Q = 8, 1,500 rows
    through each crossing, a 4,000-row duplicate scan with 20 planted
    pairs, the budget ladder at 2,048 rows with the shipped rung; every
    codec trained on at most 2,000 rows in at most 10 k-means iterations;
    K2 counted where the wrapper would count it."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery import (
        pq as tpq, pq_adc)
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_pq_scale, exp_train_budget)

    rep, said = _no_card(monkeypatch, wa)
    monkeypatch.setattr(chip_smoke, "GALLERY_SCALE", dict(
        pq=dict(g=8000, q_sweep=(4, 8), dense_g=4000),
        k2_checks=((4, "hilo"), (4, "hi"), (8, "hi")),
        wide=dict(g=9000, q=8, precision="hi"),
        sync_rows=(1500,), async_rows=1500,
        merge=dict(g=4000, dups=20, threshold=0.95),
        budget=dict(rows=2048, queries=32),
        fused=dict(g=6000, identities=600, changed=1 / 32, q=8, k=5,
                   precision="hilo", noise=0.3)))
    monkeypatch.setattr(exp_pq_scale, "CODEC_TRAIN_ROWS", 2000)
    monkeypatch.setattr(exp_train_budget, "LADDER",
                        ((1024, 3), (50_000, 10)))
    train, scores = tpq.PQCodec.train, tpq.adc_candidates

    def short_train(emb, *a, iters=20, **k):
        return train(emb[:2000], *a, iters=min(iters, 10), **k)

    def counted(*a, **k):
        pq_adc.launches += 1
        return scores(*a, **k)

    monkeypatch.setattr(tpq.PQCodec, "train", staticmethod(short_train))
    monkeypatch.setattr(tpq, "adc_candidates", counted)
    return rep, said


def test_gallery_scale_phase_rehearsed_on_the_cpu(monkeypatch):
    """Phase 23: every tool's lines said, K2 counted over the PQ-scale run,
    the search over the drawn codes and both crossings (the comparison's
    launches not counted) and equal to its plain version at each checked
    (Q, precision) and on the drawn codes, the planted pairs back, the
    shipped budget at every query, each part's seconds."""
    rep, said = _gallery_scale_on_the_cpu(monkeypatch)
    out = chip_smoke.phase_gallery_scale(torch, rep)
    # the sweep's 2 x 2 x 7 searches, then the recall study's 2, the drawn
    # codes' search; the two crossings' first PQ searches
    assert out["launches"] == 31 + 2 and out["err"] == 0.0
    text = "\n".join(said)
    for start in ("23a {\"metric\": \"pq_fill_rate (encode+scatter, "
                  "G=8000)\"",
                  "pq_adc/hi, codes 1 MB",
                  "23a K2 vs plain on the 8000 codes at Q=4 hilo",
                  "23a K2 vs plain on the 8000 codes at Q=4 hi:",
                  "23a K2 vs plain on the 8000 codes at Q=8 hi",
                  "23a 9000 codes drawn on the card",
                  "one search at Q=8 hi", "72000 scores (below 2^31), "
                  "bit-equal",
                  "23a Q=8 hi: median", "pq_topk", "peak device memory",
                  "23a {\"metric\": \"pq_recall_at_5 (rerank=100",
                  "23b sync {\"rows\": 1500", "23b async {\"mode\": \"async\"",
                  "\"bg_failed\": false", "23c {\"metric\": "
                  "\"blocked_dedup_scan_s (G=4000, 20 planted pairs",
                  "\"exact_match\": true", "\"groups_after_merge\": 3980",
                  "23d {\"train_rows\": 50000, \"iters\": 10",
                  "phase 23 took"):
        assert start in text, start


def test_gallery_scale_phase_holds_the_lookup_shape_to_the_plain_chain(
        monkeypatch):
    """23e at the cell's shape: K2 one ulp off its plain version at one
    score fails it, and so does a fused top-k that orders its winners
    otherwise than the plain chain."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc

    rep, _ = _gallery_scale_on_the_cpu(monkeypatch)
    plain, fused = pq_adc.adc_scores_plain, pq_adc.pq_adc_topk

    def off_by_an_ulp(lut, codes, precision="hilo"):
        out = plain(lut, codes, precision)
        out[0, 3] = torch.nextafter(out[0, 3], torch.tensor(np.inf))
        return out

    def swapped(*a, **k):
        s, i = fused(*a, **k)
        return s, i.flip(-1)

    with monkeypatch.context() as m:
        m.setattr(pq_adc, "pq_adc_scores", off_by_an_ulp)
        with pytest.raises(RuntimeError, match=r"23e K2 \(hilo\) differs "
                                               r"from its plain version"):
            chip_smoke.scale_fused(torch, rep)
    monkeypatch.setattr(pq_adc, "pq_adc_topk", swapped)
    with pytest.raises(RuntimeError, match=r"23e: the fused top-k \(hilo, "
                                           r"k=5\) differs from the plain "
                                           r"chain"):
        chip_smoke.scale_fused(torch, rep)


def test_gallery_scale_phase_fails_on_a_k2_that_differs(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc

    rep, _ = _gallery_scale_on_the_cpu(monkeypatch)
    plain = pq_adc.adc_scores_plain

    def off_by_an_ulp(lut, codes, precision="hilo"):
        out = plain(lut, codes, precision)
        out[0, 3] = torch.nextafter(out[0, 3], torch.tensor(np.inf))
        return out

    monkeypatch.setattr(pq_adc, "pq_adc_scores", off_by_an_ulp)
    with pytest.raises(RuntimeError, match=r"23a K2 \(hi\w*\) differs from "
                                           r"its plain version at 1 of"):
        chip_smoke.scale_search(torch, rep)


def test_gallery_scale_phase_fails_on_a_missed_pair(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.gallery import dedup

    rep, _ = _gallery_scale_on_the_cpu(monkeypatch)
    scan = dedup.find_duplicate_pairs_blocked
    monkeypatch.setattr(dedup, "find_duplicate_pairs_blocked",
                        lambda *a, **k: scan(*a, **k)[:-1])
    with pytest.raises(RuntimeError, match=r"23c the scan found 19 pairs, "
                                           r"not the 20 planted: missed "
                                           r"\[\(19, 3999\)\]"):
        chip_smoke.scale_merge(torch, rep)


def test_gallery_scale_phase_fails_on_an_async_build_that_raises(
        monkeypatch):
    import threading

    from scrfd_arcface_facerecognition_tpu_torch.gallery import AutoGallery
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_migration

    rep, _ = _gallery_scale_on_the_cpu(monkeypatch)
    build = AutoGallery._build_pq

    def fails_in_the_background(self, *a, **k):
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError("a background build that raises")
        return build(self, *a, **k)

    monkeypatch.setattr(AutoGallery, "_build_pq", fails_in_the_background)
    monkeypatch.setattr(exp_migration, "run_scale", lambda n, device: dict(
        rows=n, top1_self="16/16"))
    with pytest.raises(RuntimeError,
                       match="23b the background migration failed"):
        chip_smoke.scale_migration(torch, rep)


def test_gallery_scale_phase_fails_on_a_present_identity_missed(
        monkeypatch):
    """23a's recall study: every query whose identity has a row in the
    gallery must find that identity first."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_pq_scale

    rep, _ = _gallery_scale_on_the_cpu(monkeypatch)
    run = exp_pq_scale.run

    def one_missed(*a, **k):
        out = run(*a, **k)
        r = out["recall"][-1]
        assert r["identity_present"] <= 16 and r["top1_hits"] == r[
            "identity_present"]
        r["top1_hits"] -= 1
        return out

    monkeypatch.setattr(exp_pq_scale, "run", one_missed)
    with pytest.raises(RuntimeError, match=r"23a top-1 same identity for "
                                           r"\d+ queries, not the \d+ whose "
                                           r"identity the gallery holds "
                                           r"\(rerank=100"):
        chip_smoke.scale_search(torch, rep)


@pytest.mark.parametrize("part", ["budget", "crossing"])
def test_gallery_scale_phase_fails_on_a_top1_below_the_count(monkeypatch,
                                                             part):
    """23d at the shipped budget and 23b after the crossing need every
    query."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_migration, exp_train_budget)

    rep, _ = _gallery_scale_on_the_cpu(monkeypatch)
    if part == "budget":
        monkeypatch.setattr(exp_train_budget, "LADDER", ((50_000, 10),))
        evaluate = exp_train_budget.evaluate
        monkeypatch.setattr(exp_train_budget, "evaluate", lambda *a: (
            evaluate(*a)[0] - 1, 0.0))
        with pytest.raises(RuntimeError, match=r"23d top-1 identity 31/32 "
                                               r"at the shipped budget "
                                               r"\(50000, 10\)"):
            chip_smoke.scale_budget(torch, rep)
    else:
        monkeypatch.setattr(exp_migration, "top1_self", lambda hits: 15)
        with pytest.raises(RuntimeError, match="23b top-1 self 15/16 after "
                                               "the synchronous crossing"):
            chip_smoke.scale_migration(torch, rep)


def _host_tools_on_the_cpu(monkeypatch):
    """Phase 24 at small sizes: exp_microbatch with det_500m + w600k_mbf
    at 128 (8 requests, 4 threads), exp_convergence for 2 steps of small
    models ("w600k_mbf" and "det_500m" swapped for narrow configs, SCRFD at
    128), bench_ingest's synthetic source at 64 x 48, 12 frames, streams 1
    and 2; K1 counted where the wrapper would count it."""
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.models import arcface, scrfd
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    rep, said = _no_card(monkeypatch, wa)
    crops = ops.warp_align_crops

    def counted(*a, **k):
        wa.launches += 1
        return crops(*a, **k)

    monkeypatch.setattr(ops, "warp_align_crops", counted)
    monkeypatch.setitem(arcface.ARCFACE_CONFIGS, "w600k_mbf",
                        arcface.ArcFaceConfig(
                            name="w600k_mbf", arch="mobilefacenet",
                            mbf_blocks=(1, 1, 1, 1), mbf_stem_filters=8,
                            mbf_stem_dw_groups=8,
                            mbf_stage_filters=(8, 16, 16),
                            mbf_down_groups=(16, 16, 32),
                            mbf_res_groups=(16,) * 4, mbf_sep_filters=32))
    monkeypatch.setitem(scrfd.SCRFD_CONFIGS, "det_500m", scrfd.SCRFDConfig(
        name="det_500m", stem_filters=8, stage_blocks=(1, 1, 1, 1),
        stage_filters=(8, 8, 16, 16), neck_filters=8, head_stacks=1,
        head_filters=16))
    monkeypatch.setattr(chip_smoke, "HOST_TOOLS", dict(
        microbatch=dict(requests=8, threads=4, size=128, max_wait_ms=4.0,
                        det="det_500m", rec="w600k_mbf",
                        det_size=(128, 128)),
        convergence=dict(arc_steps=2, det_steps=2, eval_every=1, batch=8,
                         det_batch=8, size=128, min_accuracy=0.95,
                         min_ap=0.90),
        ingest=dict(res=(64, 48), frames=12, streams=(1, 2))))
    return rep, said


def test_host_and_learning_phase_rehearsed_on_the_cpu(monkeypatch):
    """Phase 24: both request modes' lines, K1 counted over the run and
    held to its plain version, each request held to its direct call; both
    curves said and handed to ``hold_learning`` (2 steps cannot learn, so
    here it only records them); the ingest table with every row at
    streams x frames and the budget at the given frames/s; each part's
    seconds."""
    rep, said = _host_tools_on_the_cpu(monkeypatch)
    held = []
    monkeypatch.setattr(chip_smoke, "hold_learning",
                        lambda curve, floor, what: held.append(
                            (what, [s for s, _ in curve], floor)))
    out = chip_smoke.phase_host_and_learning(torch, rep, 841.22)
    assert out["launches"] > 0 and out["err"] == 0.0
    assert set(out["secs"]) == {"a", "b", "c"}
    assert held == [("ArcFace held-out verification accuracy", [0, 1, 2],
                     0.95), ("SCRFD AP@0.5", [0, 1, 2], 0.90)]
    text = "\n".join(said)
    for start in ('24a {"mode": "batch-1 per request", "requests_per_sec": ',
                  '24a {"mode": "microbatched", "requests_per_sec": ',
                  "every coalesced request equal to the direct get_batch",
                  "vs plain on the run's inputs",
                  "24a one warm batch-1 get() alone under torch.profiler: "
                  "not measured",
                  '24b {"curve": "arcface_verification_accuracy", "step": 0',
                  '24b {"curve": "scrfd_ap50", "step": 2, "value": ',
                  "ms a step", "24c ## Ingest scaling (64x48 synthetic "
                  "frames drawn at read time, no codec, 12 frames/stream",
                  "24c | DecodePool [synthetic, no codec] | 2 | 2 proc |",
                  "24c Core budget: zero-copy single-stream feed = ",
                  "a card at 841 fps needs",
                  "phase 13's resident depth-12 841.22 frames/s",
                  "phase 24 took"):
        assert start in text, start


def test_hold_learning_needs_a_rise_to_the_floor():
    chip_smoke.hold_learning([(0, 0.6), (50, 0.8), (300, 0.96)], 0.95, "a")
    for curve in ([(0, 0.6), (300, 0.6)], [(0, 0.96), (300, 0.96)],
                  [(0, 0.5), (300, 0.94)]):
        with pytest.raises(RuntimeError, match="24b a did not learn"):
            chip_smoke.hold_learning(curve, 0.95, "a")


def test_host_phase_fails_on_a_k1_one_u8_off(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    rep, _ = _host_tools_on_the_cpu(monkeypatch)
    plain = wa.warp_align_plain
    monkeypatch.setattr(wa, "warp_align_crops",
                        lambda *a, **k: plain(*a, **k) + 1 / 127.5)
    with pytest.raises(RuntimeError, match="warp_align: max abs err 1.0"):
        chip_smoke.host_microbatch(torch, rep)


def test_host_phase_fails_when_k1_is_launched_no_time(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    rep, _ = _host_tools_on_the_cpu(monkeypatch)
    monkeypatch.setattr(ops, "warp_align_crops", wa.warp_align_crops)
    with pytest.raises(RuntimeError,
                       match="24a exp_microbatch launched K1 no time"):
        chip_smoke.host_microbatch(torch, rep)


def test_host_phase_fails_on_a_flat_curve(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_convergence

    rep, _ = _host_tools_on_the_cpu(monkeypatch)

    def curve(values):
        return lambda *a, **k: dict(
            curve=[(50 * i, v) for i, v in enumerate(values)],
            losses=[1.0], ms_step=1.0, elapsed_s=1.0)

    monkeypatch.setattr(exp_convergence, "run_arcface",
                        curve([0.6, 0.6, 0.6]))
    monkeypatch.setattr(exp_convergence, "run_scrfd", curve([0.0, 0.95]))
    with pytest.raises(RuntimeError, match=r"24b ArcFace held-out "
                                           r"verification accuracy did not "
                                           r"learn: \[\(0, 0.6\)"):
        chip_smoke.host_convergence(torch, rep)
    monkeypatch.setattr(exp_convergence, "run_arcface", curve([0.6, 1.0]))
    monkeypatch.setattr(exp_convergence, "run_scrfd", curve([0.0, 0.0]))
    with pytest.raises(RuntimeError, match="24b SCRFD AP@0.5 did not learn"):
        chip_smoke.host_convergence(torch, rep)


def test_host_phase_fails_on_an_ingest_row_short_of_frames(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.tools import bench_ingest

    rep, _ = _host_tools_on_the_cpu(monkeypatch)
    multistream = bench_ingest.bench_multistream

    def one_short(source, n_streams):
        fps, n = multistream(source, n_streams)
        return fps, n - (n_streams == 2)

    monkeypatch.setattr(bench_ingest, "bench_multistream", one_short)
    with pytest.raises(RuntimeError, match=r"24c MultiStreamReader \(threads, "
                                           r"GIL\) over 2 streams \(thread\) "
                                           r"gave 23 frames, not 24"):
        chip_smoke.host_ingest(torch, rep, 841.22)


def _measure_tools_on_the_cpu(monkeypatch):
    """Phase 25 at small sizes: "det_10g" and "w600k_r50" swapped for
    narrow configs, profile_stages on 2 and 3 frames of 270 x 480,
    exp_r50 on 8 crops, exp_r50b at B = 4 and 2, exp_scrfd at 128, one
    traced iteration, exp_int8 on one small conv, a 64 GEMM and the chain
    at a sixteenth of its sides; K1 counted where the wrapper would count
    it."""
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.models import arcface, scrfd
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_int8, profile_stages)

    rep, said = _no_card(monkeypatch, wa)
    crops = ops.warp_align_crops

    def counted(*a, **k):
        wa.launches += 1
        return crops(*a, **k)

    monkeypatch.setattr(ops, "warp_align_crops", counted)
    monkeypatch.setitem(arcface.ARCFACE_CONFIGS, "w600k_r50",
                        arcface.ArcFaceConfig(
                            name="w600k_r50", arch="iresnet",
                            stage_blocks=(1, 1, 1, 1),
                            stage_filters=(8, 8, 16, 16)))
    monkeypatch.setitem(scrfd.SCRFD_CONFIGS, "det_10g", scrfd.SCRFDConfig(
        name="det_10g", stem_filters=8, stage_blocks=(1, 1, 1, 1),
        stage_filters=(8, 8, 16, 16), neck_filters=8, head_stacks=1,
        head_filters=16))
    monkeypatch.setattr(profile_stages, "SETTINGS", dict(
        profile_stages.SETTINGS, frame_hw=(270, 480)))
    monkeypatch.setattr(chip_smoke, "PROFILE_TOOLS", dict(
        profile_stages=dict(batches=(2, 3), iters=1),
        exp_r50=dict(n=8, sweep=(2, 4), iters=1, check_n=4),
        exp_r50b=dict(batches=(4, 2)),
        exp_scrfd=dict(batch=1, iters=1, size=128),
        trace_ops=dict(what="backbone", batch=1, iters=1, top=5),
        exp_int8=dict(convs=((2, 8, 8, 28, 28),), matmul=64,
                      chain_batch=1)))
    shapes = exp_int8.chain_shapes()
    monkeypatch.setattr(exp_int8, "chain_shapes", lambda: [
        (h // 16, w // 16, ci, co, s) for h, w, ci, co, s in shapes])
    return rep, said


def test_measure_tools_phase_rehearsed_on_the_cpu(monkeypatch):
    """Phase 25: every tool's rows said under its part's tag, K1 counted
    over profile_stages and held to its plain version, each tool's check
    said, each part's seconds."""
    rep, said = _measure_tools_on_the_cpu(monkeypatch)
    out = chip_smoke.phase_measure_tools(torch, rep)
    # K1 in the embed + match stage and the warp row, 3 calls each a
    # batch at iters=1 (the row's first call, the warm-up, the timed one)
    assert out["launches"] == 2 * 6 and out["err"] == 0.0
    assert set(out["secs"]) == {"a", "b-c", "d", "e", "f"}
    text = "\n".join(said)
    for start in ("25a B=2 detect (full stage 1)", "25a B=3   faces=",
                  "25a B=3   warp (K1)", "25a B=2   arcface normalize"
                  "                        fused in K1",
                  "25a K1 12 launches over profile_stages at batches [2, 3],"
                  " vs plain on the runs' inputs, 2 calls",
                  "25b [1] r50 bf16 NCHW B=8: ", "25b [3] channels_last: ",
                  "25b [4] f32 (TF32 off): ",
                  "25b the full prefix plus the head equals the forward on 4"
                  " crops (max abs diff 0.0)",
                  "25c variant agreement ok", "25c [full D] B=2: ",
                  "25d stem: plain 3x3 stride 2",
                  "25d det_10g widths 64/128/256",
                  "25d backbone -> neck -> head composes to SCRFDNet's "
                  "outputs: scores max abs diff 0",
                  "25e wall: ", "25e trace trace.json: ",
                  "CPU-op (--device cpu) time",
                  "25f int8 conv B2 8x8 C28F28: ", "25f chain speedup",
                  "25f every int8 conv (1 geometries, 28 chain convs) and the"
                  " int8 GEMM equal float64 on the card exactly",
                  "phase 25 took"):
        assert start in text, start


def test_measure_phase_fails_on_a_k1_one_u8_off(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    rep, _ = _measure_tools_on_the_cpu(monkeypatch)
    plain = wa.warp_align_plain
    monkeypatch.setattr(wa, "warp_align_crops",
                        lambda *a, **k: plain(*a, **k) + 1 / 127.5)
    with pytest.raises(RuntimeError, match="warp_align: max abs err 1.0"):
        chip_smoke.tools_profile(torch, rep)


def test_measure_phase_fails_when_k1_is_launched_no_time(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    rep, _ = _measure_tools_on_the_cpu(monkeypatch)
    monkeypatch.setattr(ops, "warp_align_crops", wa.warp_align_crops)
    with pytest.raises(RuntimeError,
                       match="25a profile_stages launched K1 no time"):
        chip_smoke.tools_profile(torch, rep)


@pytest.mark.parametrize("fault", ["r50_prefix", "r50b_head", "scrfd_parts",
                                   "no_trace_events", "int8_inexact"])
def test_measure_phase_fails_on_each_tools_check(monkeypatch, fault):
    """Each part of phase 25 fails on its own check: a prefix plus head off
    the forward, a head variant off A, parts that do not compose, a trace
    with no op event, an int8 result off float64."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_int8, exp_r50, exp_r50b, exp_scrfd, trace_ops)

    rep, _ = _measure_tools_on_the_cpu(monkeypatch)
    if fault == "r50_prefix":
        monkeypatch.setattr(exp_r50, "check", lambda model, x: 0.0625)
        run, match = chip_smoke.tools_r50, "25b exp_r50: stem..layer4 then"
    elif fault == "r50b_head":
        head_c = exp_r50b.head_c
        monkeypatch.setitem(exp_r50b.HEADS, "C", lambda x, w, b: head_c(
            x, w, b) * 1.001)
        run, match = chip_smoke.tools_r50, r"exp_r50b: head variants \{'C'"
    elif fault == "scrfd_parts":
        monkeypatch.setattr(exp_scrfd, "compose_gap", lambda whole, head: {
            k: 1.0 for k in whole})
        run, match = chip_smoke.tools_scrfd, "25d exp_scrfd: backbone -> "
    elif fault == "no_trace_events":
        monkeypatch.setattr(trace_ops, "CPU_CATS", ("none",))
        run, match = chip_smoke.tools_trace, "holds no CPU op event"
    else:
        gap = exp_int8.exact_conv_gap
        monkeypatch.setattr(exp_int8, "exact_conv_gap",
                            lambda x, w, got: gap(x, w, got) + 1)
        run, match = chip_smoke.tools_int8, "25f exp_int8: int8 results "
    with pytest.raises(RuntimeError, match=match):
        run(torch, rep)


def test_measure_phase_runs_the_tools_defaults():
    """Phase 25's settings are the tools' defaults (profile_stages also at
    96 frames)."""
    import inspect

    from scrfd_arcface_facerecognition_tpu_torch.tools import (
        exp_int8, exp_r50, exp_r50b, exp_scrfd, profile_stages, trace_ops)

    c = chip_smoke.PROFILE_TOOLS

    def default(fn, name):
        return inspect.signature(fn).parameters[name].default

    assert c["profile_stages"]["batches"] == (
        default(profile_stages.run, "batch"), 96)
    assert c["profile_stages"]["iters"] == default(profile_stages.run,
                                                   "iters")
    assert (c["exp_r50"]["n"], c["exp_r50"]["sweep"],
            c["exp_r50"]["iters"]) == (exp_r50.CROPS, exp_r50.SWEEP, 10)
    assert c["exp_r50b"]["batches"] == exp_r50b.BATCHES
    assert (c["exp_scrfd"]["batch"], c["exp_scrfd"]["iters"],
            c["exp_scrfd"]["size"]) == (32, 20, 640)
    assert c["trace_ops"] == dict(what="backbone", batch=32, iters=5,
                                  top=30)
    assert c["exp_int8"] == dict(convs=exp_int8.CONVS,
                                 matmul=exp_int8.MATMUL,
                                 chain_batch=exp_int8.CHAIN_BATCH)
    for fn, name, want in ((exp_scrfd.run, "batch", 32),
                           (trace_ops.run, "what", "backbone")):
        assert default(fn, name) == want


# ------------------------------------------------------------------ phase 26


def _decisions_on_the_cpu(monkeypatch):
    """Phase 26 at small sizes: 4 eval, 3 train and 2 val identities, 2
    visits an identity and 2 verification pairs, 2 steps of each trainer
    (batches of 2 and 8, eval every 2) from the committed weights, the
    replay's 6 visits (2 of them missing) through det_500m + w600k_mbf at
    128; K1 counted where the wrapper would count it."""
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    rep, said = _no_card(monkeypatch, wa)
    crops = ops.warp_align_crops

    def counted(*a, **k):
        wa.launches += 1
        return crops(*a, **k)

    monkeypatch.setattr(ops, "warp_align_crops", counted)
    monkeypatch.setattr(chip_smoke, "DECISIONS", dict(
        ids=dict(eval=4, train=3, val=2), seed=0,
        eval=dict(visits=2, pairs=2),
        train=dict(det_steps=2, emb_steps=2, eval_every=2, det_batch=2,
                   emb_batch=8, per_id=2),
        replay=dict(visits=6, misses=2, det="det_500m", rec="w600k_mbf",
                    det_size=(128, 128))))
    return rep, said


def test_decisions_phase_rehearsed_on_the_cpu(monkeypatch):
    """Phase 26: the eval's metrics at f32 equal on both runs and the bf16
    run's counts; the trainers' JAX line keys, the checkpoints read back
    and eval from them equal; the replay's counts; K1 counted over the
    three parts and held to its plain version; each part's seconds."""
    rep, said = _decisions_on_the_cpu(monkeypatch)
    out = chip_smoke.phase_decisions(torch, rep)
    assert out["launches"] > 0 and out["err"] == 0.0
    assert set(out["secs"]) == {"a", "b", "c"}
    a = out["out"]["a"]
    assert a["tie"] is None
    assert a["f32"]["counters"] == a["cpu"]["counters"]
    assert a["f32"]["n_visits"] == 4 * 2 + 2
    c = out["out"]["c"]
    assert c["visits_handled"] == 6 and c["results"]["download_failed"] == 2
    text = "\n".join(said)
    for start in ('26a card f32 {"entry": "json"',
                  "the card's metrics equal the CPU's",
                  '26a card bf16 {"entry": "json"', "10 visits handled of 10",
                  '26b {"curve": "decisions_det_ap50", "step": 2',
                  '26b {"stage": "extract_aligned"',
                  '26b {"stage": "model_selection"',
                  "read back bit for bit, eval from the files equal",
                  '26c {"results": ', "6 visits (2 missing from the cache)",
                  "= new persons", "26 K1 ", "vs plain on the card's inputs",
                  "phase 26 took"):
        assert start in text, start


def _stub_parts(monkeypatch, part_a=lambda *a: {}):
    monkeypatch.setattr(chip_smoke, "decisions_eval", part_a)
    monkeypatch.setattr(chip_smoke, "decisions_train", lambda *a: {})
    monkeypatch.setattr(chip_smoke, "decisions_replay", lambda *a: {})


def test_decisions_phase_fails_when_k1_is_launched_no_time(monkeypatch):
    rep, _ = _decisions_on_the_cpu(monkeypatch)
    _stub_parts(monkeypatch)
    with pytest.raises(RuntimeError,
                       match="26 the decision tools launched K1 no time"):
        chip_smoke.phase_decisions(torch, rep)


def test_decisions_phase_fails_on_a_k1_one_u8_off(monkeypatch):
    from scrfd_arcface_facerecognition_tpu_torch import ops
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    rep, _ = _decisions_on_the_cpu(monkeypatch)

    def one_face(*a):
        frames = torch.zeros((1, 64, 64, 3), dtype=torch.uint8) + 7
        m = torch.tensor([[[0.5, 0.0, 3.0], [0.0, 0.5, 2.0]]])
        ops.warp_align_crops(frames, m, torch.zeros(1, dtype=torch.int32))
        return {}

    _stub_parts(monkeypatch, one_face)
    plain = wa.warp_align_plain
    monkeypatch.setattr(wa, "warp_align_crops",
                        lambda *a, **k: plain(*a, **k) + 1 / 127.5)
    with pytest.raises(RuntimeError, match=r"warp_align: max abs err "
                                           r"(1\.0|0\.99999)"):
        chip_smoke.phase_decisions(torch, rep)


def _metrics(**changes):
    m = {"entry": "json", "elapsed_s": 1.0,
         "counters": {"processed": 8, "new_persons": 3},
         "verification": {"pairs": 4, "same_sim_mean": 0.81234}}
    for k, v in changes.items():
        m[k] = v
    return m


def test_hold_decisions_names_ties_and_fails_the_rest():
    thr = chip_smoke.decision_thresholds()
    assert 0.55 in thr and 0.95 in thr and 0.8 in thr
    trace = [("search", [0.7, 0.2]), ("compare", [0.3])]
    # equal (elapsed_s aside, the means within 1e-4)
    assert chip_smoke.hold_decisions(
        _metrics(), _metrics(elapsed_s=9.0, verification={
            "pairs": 4, "same_sim_mean": 0.81239}), trace, trace,
        thr) is None
    changed = _metrics(counters={"processed": 8, "new_persons": 4})
    # a decision that flips at a tie (0.55 +- 3e-5) explains the change
    tie = chip_smoke.hold_decisions(
        _metrics(), changed, [("search", [0.55003])],
        [("search", [0.54998])], thr)
    assert "flipped at a tie" in tie and "0.55" in tie
    # a flip away from the threshold fails
    with pytest.raises(RuntimeError, match=r"26a metrics\['counters'\].*"
                                           r"decision 0 \(search\) flipped"
                                           r".*not a tie"):
        chip_smoke.hold_decisions(_metrics(), changed, [("search", [0.56])],
                                  [("search", [0.54])], thr)
    # a changed decision with every similarity equal fails
    with pytest.raises(RuntimeError, match="no similarity the engines "
                                           "decided on flipped"):
        chip_smoke.hold_decisions(_metrics(), changed, trace, trace, thr)
    with pytest.raises(RuntimeError, match="similarity 0.7000000 on the "
                                           "card, 0.6990000 on the CPU"):
        chip_smoke.hold_decisions(_metrics(), changed, trace,
                                  [("search", [0.699, 0.2])], thr)


def test_decisions_phase_fails_on_a_changed_f32_decision(monkeypatch,
                                                        tmp_path):
    """The card's f32 eval (the first of 26a's runs) with one more person
    than the CPU's, its similarities unchanged: no tie explains it."""
    from scrfd_arcface_facerecognition_tpu_torch.tools import exp_decisions

    rep, _ = _decisions_on_the_cpu(monkeypatch)
    run = exp_decisions.run_decision_eval
    calls = []

    def first_changed(*a, **k):
        m = run(*a, **k)
        calls.append(1)
        if len(calls) == 1:
            m["counters"]["new_persons"] += 1
        return m

    monkeypatch.setattr(exp_decisions, "run_decision_eval", first_changed)
    data = chip_smoke.decision_data()
    trees = exp_decisions.load_checkpoints()[:2]
    with pytest.raises(RuntimeError, match=r"26a metrics\['counters'\]"
                                           r"\['new_persons'\]: .* and no "
                                           r"similarity the engines decided "
                                           r"on flipped"):
        chip_smoke.decisions_eval(torch, rep, data, trees, str(tmp_path))


def test_phases_parse_and_pull_in_what_they_need():
    assert chip_smoke.parse_phases("1-4,26") == {1, 2, 3, 4, 26}
    assert chip_smoke.parse_phases(" 23 ") == {23}
    for bad in ("0-3", "27", "5-4", "", "a", "3,,4"):
        with pytest.raises(ValueError, match="--phases"):
            chip_smoke.parse_phases(bad)
    # 1 and 2 always run; 3 and 26 need nothing
    assert chip_smoke.resolve_phases({1, 2, 3, 26}) == ([3, 26], [], {})
    phases, added, why = chip_smoke.resolve_phases({5, 8, 24})
    assert phases == [4, 5, 7, 8, 13, 24] and added == [4, 7, 13]
    assert why == {4: 7, 7: 8, 13: 24}
    phases, added, why = chip_smoke.resolve_phases({16, 17, 20, 21})
    assert phases == [4, 7, 12, 13, 15, 16, 17, 18, 19, 20, 21]
    assert why[15] == 16 and why[13] == 15 and why[12] == 17
    assert why[18] == why[19] == 21
    # every need is an earlier phase, and the default runs them all
    assert all(n < p for p, ns in chip_smoke.PHASE_NEEDS.items() for n in ns)
    args, selected = chip_smoke.parse_args([])
    assert selected == set(range(3, 27)) and not args.full_scale
    assert chip_smoke.parse_args(["--full-scale"])[1] == {23}
    assert chip_smoke.parse_args(["--phases", "26", "--full-scale"])[1] == {
        23, 26}
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--phases", "0"])


def test_the_default_phase23_still_searches_past_2_31():
    """The default call's cut phase 23 keeps a search of Q x G past 2^31
    scores (the drawn codes at Q = 256 "hi"), and --full-scale runs the
    JAX tools' defaults."""
    wide = chip_smoke.GALLERY_SCALE["wide"]
    assert wide["q"] * wide["g"] > 2 ** 31 and wide["precision"] == "hi"
    assert wide["g"] == 10_000_000 and wide["q"] == 256
    full = chip_smoke.GALLERY_SCALE_FULL
    assert full["wide"] is None
    assert full["pq"] == dict(g=10_000_000, q_sweep=(16, 64, 128, 256),
                              dense_g=2_000_000)
    assert (256, "hi") in full["k2_checks"]
    assert 256 * full["pq"]["g"] > 2 ** 31
    assert full["sync_rows"] == (1_000_000, 2_000_000)
    assert full["merge"]["g"] == 1_000_000
    assert full["budget"] == dict(rows=1_000_000, queries=256)
    # the default keeps both crossings and an exact scan, smaller
    d = chip_smoke.GALLERY_SCALE
    assert d["sync_rows"] and d["async_rows"] and d["merge"]["dups"] > 0


def test_kernel_rows_list_the_kernels_whose_timing_phase_ran():
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    t = dict(ms=1.0, plain_ms=2.0, bound_ms=0.5, bound_by="bytes",
             library_ms=3.0)
    r = {4: dict(launches=5, err=0.0, t=t), 26: dict(launches=7, err=0.0),
         23: dict(launches=3, err=0.0)}
    rows = chip_smoke.kernel_rows(torch, wa, pq_adc, r)
    assert [k["name"] for k in rows] == [wa.NAME]
    assert rows[0]["launches"] == 12 and rows[0]["ms"] == 1.0
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert set(rows[0]) == keys


def test_kernel_rows_give_k2_the_fused_topk_when_phase_23_ran():
    """K2's row takes the fused top-k's times and its own bound from
    phase 23 (23e), beside K2's own from phase 7; without phase 23 it has
    none."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc
    from scrfd_arcface_facerecognition_tpu_torch.ops import warp_align as wa

    t = dict(ms=1.0, plain_ms=2.0, bound_ms=0.5, bound_by="bytes",
             library_ms=3.0)
    shape = dict(q=64, g=10_000_000, k=5, precision="hilo")
    topk = dict(ms=15.0, plain_ms=90.0, bound_ms=0.6,
                bound_by="operations", library_ms=52.0, shape=shape)
    r = {7: dict(launches=6, err=0.0, times=t),
         23: dict(launches=3, err=0.0, topk=topk)}
    rows = chip_smoke.kernel_rows(torch, wa, pq_adc, r)
    assert [k["name"] for k in rows] == [pq_adc.NAME]
    assert rows[0]["launches"] == 9 and rows[0]["bound_ms"] == 0.5
    assert rows[0]["topk"] == topk
    del r[23]
    assert "topk" not in chip_smoke.kernel_rows(torch, wa, pq_adc, r)[0]
