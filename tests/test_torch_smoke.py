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
    crops, scores = ops.warp_align_crops, pq.pq_adc_scores

    def counted_crops(*a, **k):
        wa.launches += 1
        return crops(*a, **k)

    def counted_scores(*a, **k):
        pq_adc.launches += 1
        return scores(*a, **k)

    monkeypatch.setattr(ops, "warp_align_crops", counted_crops)
    monkeypatch.setattr(pq, "pq_adc_scores", counted_scores)
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
