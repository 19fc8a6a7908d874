"""The port's decision-quality tool (``tools/exp_decisions.py`` of the port)
and its cv2-free image helpers (``tools/host_images.py``) against cv2 and
the JAX repository's ``tools/exp_decisions.py``, on the CPU.

The JAX tool is loaded from ``tools/`` by path (the trainers and the
alignment: ``tests/test_torch_decisions_train.py``). Tolerances:

- the resizes: bit-equal to cv2 (``resize_area_u8`` on INTER_AREA's three
  routes, ``resize_linear_f32`` on the maps ``make_scene`` enlarges,
  ``resize_linear_u8`` at the sizes ``augment`` restores);
- the data: bit-equal (``load_sources`` over cv2-written JPEGs,
  ``split_identities``, ``augment``, ``make_scene``'s image, box and
  landmarks, ``make_pairs``, ``pairwise_prf``);
- ``run_decision_eval`` on the committed checkpoints, both tools at f32
  on the same synthetic identities: the whole metrics dict equal except
  ``elapsed_s``, the verification means (similarities) within 1e-4;
- ``main`` takes the JAX tool's flags (``--device`` for ``--backend``) and
  writes under ``--out-dir``: ``checkpoints/decisions/`` is byte-identical
  after it.
"""
import functools
import hashlib
import json
import os
import sys

import cv2
import jax
import numpy as np
import pytest

from scrfd_arcface_facerecognition_tpu_torch.tools import (
    exp_decisions as tx, host_images as hi)
from test_torch_host_tools import _bit_equal, _jax_tool
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CKPT = os.path.join(_REPO, "checkpoints", "decisions")
SIM_TOL = 1e-4


@pytest.fixture(scope="module")
def jx():
    return _jax_tool("exp_decisions")


@pytest.fixture(scope="module")
def crops():
    """Eight synthetic identities, two of them smaller than every box (the
    paste enlarges them)."""
    c, _ = tx.synthetic_crops(8, 0)
    return c[:6] + [c[6][:100, :100].copy(), c[7][:150, :150].copy()]


# -------------------------------------------------------------- the resizes


@pytest.mark.parametrize("src,dst,ch", [
    (288, 144, 3), (576, 288, 3), (224, 112, 1),    # the 2 x 2 mean
    (864, 288, 3), (300, 100, 1),                   # other integer factors
    (288, 173, 3), (250, 112, 3), (1000, 288, 3),   # the general area path
    (287, 208, 1), (288, 113, 3),
    (100, 112, 3), (120, 208, 3), (104, 208, 3),    # enlarging
    (57, 190, 1)], ids=lambda v: str(v))
def test_resize_area_u8_is_cv2s(src, dst, ch):
    rng = np.random.default_rng(src * 1000 + dst)
    img = rng.integers(0, 256, (src, src, ch)[:3 if ch == 3 else 2],
                       dtype=np.uint8)
    want = cv2.resize(img, (dst, dst), interpolation=cv2.INTER_AREA)
    _bit_equal(hi.resize_area_u8(img, (dst, dst)), want)


def test_resize_area_u8_on_non_square_images():
    rng = np.random.default_rng(3)
    for (h, w), (oh, ow) in (((100, 80), (50, 40)), ((90, 120), (45, 60)),
                             ((100, 80), (33, 70)), ((50, 60), (150, 77))):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        _bit_equal(hi.resize_area_u8(img, (oh, ow)),
                   cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("scene", [320, 64, 100, 256, 333, 640, 1000])
def test_resize_linear_f32_is_cv2s_on_make_scenes_maps(scene):
    """The low-frequency map ``make_scene`` enlarges (scene // 16 to
    scene, float32, 3 channels), as cv2 resizes it through IPP."""
    rng = np.random.default_rng(scene)
    for _ in range(3):
        lf = (rng.normal(size=(scene // 16, scene // 16, 3)) * 22).astype(
            np.float32)
        want = cv2.resize(lf, (scene, scene), interpolation=cv2.INTER_LINEAR)
        _bit_equal(hi.resize_linear_f32(lf, (scene, scene)), want)


@pytest.mark.parametrize("src,dst", [(244, 288), (287, 288), (150, 176),
                                     (88, 100)])
def test_resize_linear_u8_is_cv2s_where_augment_restores(src, dst):
    rng = np.random.default_rng(src)
    img = rng.integers(0, 256, (src, src, 3), dtype=np.uint8)
    _bit_equal(hi.resize_linear_u8(img, (dst, dst)),
               cv2.resize(img, (dst, dst), interpolation=cv2.INTER_LINEAR))


def test_host_images_refuse_what_they_do_not_cover(monkeypatch):
    with pytest.raises(ValueError, match="float32 \\(H, W, 3\\)"):
        hi.resize_linear_f32(np.zeros((4, 4), np.float32), (8, 8))
    with pytest.raises(ValueError, match="enlarges"):
        hi.resize_linear_f32(np.zeros((8, 8, 3), np.float32), (4, 4))
    with pytest.raises(ValueError, match="needs uint8"):
        hi.resize_area_u8(np.zeros((8, 8), np.float32), (4, 4))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="needs cv2"):
        hi.imread("any.jpg")


# ----------------------------------------------------------------- the data


def test_load_sources_and_split_are_the_jax_tools(jx, tmp_path):
    """cv2-written JPEGs of several shapes: tall and wide ones square-
    cropped, ones above 288 shrunk (576: the fast path; 700, 401: the
    general one), ones below kept; a file that is no image skipped."""
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(((700, 420), (300, 576), (200, 200),
                                (576, 900), (401, 401), (120, 90))):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        assert cv2.imwrite(str(tmp_path / f"{i:03d}.jpg"), img)
    (tmp_path / "999.jpg").write_bytes(b"not a jpeg")
    jc, jn = jx.load_sources(str(tmp_path))
    tc, tn = tx.load_sources(str(tmp_path))
    assert jn == tn and len(tn) == 6
    for a, b in zip(jc, tc):
        _bit_equal(b, a)
    assert {c.shape[0] for c in tc} == {288, 200, 90}
    for n in (6, 70, 360):
        for part_j, part_t in zip(jx.split_identities(n, 3),
                                  tx.split_identities(n, 3)):
            _bit_equal(part_t, part_j)


def test_compositing_is_the_jax_tools(jx, crops):
    for seed in range(3):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        for crop in crops:
            _bit_equal(tx.augment(rt, crop), jx.augment(rj, crop))
            for a, b in zip(jx.make_scene(rj, crop), tx.make_scene(rt, crop)):
                _bit_equal(b, a)
        _bit_equal(rt.random(4), rj.random(4))         # still in step
    ann_j = jx.scene_annotation(3, *jx.make_scene(np.random.default_rng(1),
                                                  crops[0])[1:])
    ann_t = tx.scene_annotation(3, *tx.make_scene(np.random.default_rng(1),
                                                  crops[0])[1:])
    assert ann_j.path == ann_t.path == "3"
    for f in ("boxes", "kps", "kps_valid"):
        _bit_equal(getattr(ann_t, f), getattr(ann_j, f))


def test_pairs_and_prf_are_the_jax_tools(jx):
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(30, 4, 4, 3)).astype(np.float32)
    labels = rng.integers(0, 6, 30)
    pj = jx.make_pairs(arr, labels, 12, 5)
    pt = tx.make_pairs(arr, labels, 12, 5)
    assert len(pt) == len(pj) == 24
    for (a, b, s), (c, d, u) in zip(pj, pt):
        _bit_equal(c, a)
        _bit_equal(d, b)
        assert s == u
    for trial in range(4):
        keys = [f"u{i}" for i in range(12)]
        truth = {k: int(rng.integers(0, 4)) for k in keys}
        assign = {k: int(rng.integers(0, 5)) for k in keys
                  if rng.random() < 0.8}
        assert tx.pairwise_prf(assign, truth) == jx.pairwise_prf(assign,
                                                                truth)
    assert tx.pairwise_prf({}, {}) == jx.pairwise_prf({}, {})


def test_synthetic_crops_are_seeded_identities():
    a, names = tx.synthetic_crops(3, 4)
    b, _ = tx.synthetic_crops(3, 4)
    assert names == ["synthetic_0000.jpg", "synthetic_0001.jpg",
                     "synthetic_0002.jpg"]
    for x, y in zip(a, b):
        _bit_equal(x, y)
        assert x.shape == (288, 288, 3) and x.dtype == np.uint8
    assert not np.array_equal(a[0], a[1])


# --------------------------------------------------------- the decision eval


def _checkpoint_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _checkpoint_trees_equal(a[k], b[k])
        else:
            _bit_equal(np.asarray(b[k]), np.asarray(a[k]))


@pytest.fixture(scope="module")
def trees(jx):
    """The committed checkpoints, each tool's ``load_checkpoints``: the
    port's (msgpack read without Flax) bit-equal to JAX's."""
    jd, je, jmeta = jx.load_checkpoints()
    td, te, tmeta = tx.load_checkpoints()
    assert jmeta == tmeta
    _checkpoint_trees_equal(jax.tree.map(np.asarray, jd), td)
    _checkpoint_trees_equal(jax.tree.map(np.asarray, je), te)
    return jd, je, td, te


@pytest.fixture(scope="module")
def apps(jx, trees):
    """Both tools' facades on the committed checkpoints at f32, built
    once: JAX compiles a shape once per facade."""
    jd, je, td, te = trees
    return (jd, je, jx.build_app(jd, je)), (td, te, tx.build_app(
        td, te, device="cpu"))


def _same_metrics(jm, tm):
    jm, tm = dict(jm), dict(tm)
    jm.pop("elapsed_s")
    tm.pop("elapsed_s")
    jv, tv = jm.pop("verification"), tm.pop("verification")
    assert tm == jm
    assert tv["pairs"] == jv["pairs"]
    assert tv["accuracy_at_0.2"] == jv["accuracy_at_0.2"]
    for k in ("same_sim_mean", "diff_sim_mean"):
        assert (tv[k] is None) == (jv[k] is None), k
        if tv[k] is not None:
            assert abs(tv[k] - jv[k]) <= SIM_TOL, (k, tv[k], jv[k])


def _decision_eval(jx, apps, crops, tmp_path, ids, visits, pairs, seed):
    (jd, je, japp), (td, te, tapp) = apps
    kw = dict(visits_per_id=visits, n_verif_pairs=pairs, seed=seed,
              log=lambda s: None)
    jm = jx.run_decision_eval(jd, je, crops, ids, str(tmp_path / "jax"),
                              app=japp, **kw)
    tm = tx.run_decision_eval(td, te, crops, ids, str(tmp_path / "port"),
                              app=tapp, **kw)
    _same_metrics(jm, tm)
    n_genuine = len(ids) * visits
    assert tm["n_visits"] == n_genuine + 2
    # not vacuous: most visits reach the gallery, both probes fire
    assert tm["counters"]["processed"] >= tm["n_visits"] / 2, tm
    assert tm["counters"]["duplicate_faces"] >= 2, tm
    assert tm["verification"]["pairs"] == 2 * pairs
    return tm


def test_decision_eval_matches_jax_on_the_checkpoints(jx, apps, crops,
                                                      tmp_path):
    _decision_eval(jx, apps, crops, tmp_path, np.asarray([0, 3, 6, 7]), 2,
                   2, 0)


@pytest.mark.slow
def test_decision_eval_matches_jax_on_the_live_decide_slice(jx, apps, crops,
                                                            tmp_path):
    """The slice of the JAX repository's
    ``test_live_decide_path_groups_unseen_identities``: 6 identities x 2
    visits, 4 pairs, seed 1."""
    _decision_eval(jx, apps, crops, tmp_path, np.arange(6), 2, 4, 1)


def test_decision_eval_reads_a_visits_file_too(jx, apps, crops, tmp_path):
    """entry="file": the file entry point and its grouping threshold."""
    (jd, je, japp), (td, te, tapp) = apps
    kw = dict(visits_per_id=1, n_verif_pairs=1, seed=2, entry="file",
              log=lambda s: None, grouping_thr=0.5)
    ids = np.asarray([1, 2, 4])
    jm = jx.run_decision_eval(jd, je, crops, ids, str(tmp_path / "j"),
                              app=japp, **kw)
    tm = tx.run_decision_eval(td, te, crops, ids, str(tmp_path / "t"),
                              app=tapp, **kw)
    _same_metrics(jm, tm)
    assert tm["entry"] == "file" and tm["grouping_threshold"] == 0.5


# ---------------------------------------------------------------- the CLI


def _hashes(root):
    return {name: hashlib.sha256(open(os.path.join(root, name), "rb")
                                 .read()).hexdigest()
            for name in sorted(os.listdir(root))}


def test_main_takes_the_jax_flags_and_writes_only_under_out_dir(
        monkeypatch, tmp_path, capsys):
    before = _hashes(_CKPT)
    cache = tmp_path / "cache"
    cache.mkdir()
    for i, c in enumerate(tx.synthetic_crops(6, 1)[0]):
        assert cv2.imwrite(str(cache / f"{i:03d}.jpg"), c)
    monkeypatch.setattr(tx, "N_TEST_IDS", 3)
    monkeypatch.setattr(tx, "N_VAL_IDS", 1)
    monkeypatch.setattr(tx, "run_decision_eval", functools.partial(
        tx.run_decision_eval, n_verif_pairs=1))
    td, te, meta = tx.load_checkpoints()
    trained = []
    monkeypatch.setattr(tx, "train_detector", lambda crops, ids, steps, **k: (
        trained.append(("det", len(ids), steps, k)) or (td, [(steps, 1.0)])))
    monkeypatch.setattr(tx, "train_embedder", lambda dv, crops, t, v, steps,
                        **k: (trained.append(("emb", len(t), len(v), steps,
                                              k["per_id"])) or
                              (te, [(0, 0.5, 0.5)], {"step": 0, "val": 0.5})))
    out = tmp_path / "out"
    common = ["--seed", "0", "--workdir", str(tmp_path / "work"),
              "--visits-per-id", "1", "--cache-dir", str(cache),
              "--out-dir", str(out), "--device", "cpu"]
    assert tx.main(["all", "--det-steps", "3", "--emb-steps", "4",
                    "--per-id", "2", "--entry", "file"] + common) == 0
    assert [t[:3] for t in trained] == [("det", 2, 3), ("emb", 2, 1)]
    assert trained[0][3]["seed"] == 0 and trained[0][3]["device"] == "cpu"
    assert trained[1][3:] == (4, 2)
    assert sorted(os.listdir(out)) == ["det_500m.pt", "meta.json",
                                       "metrics_file.json", "w600k_mbf.pt"]
    assert tx.load_checkpoints(str(out))[2]["det_steps"] == 3
    assert tx.main(["eval", "--sweep-thresholds", "0.5", "0.6"] + common
                   ) == 0
    assert (out / "metrics_sweep.json").exists()
    lines = capsys.readouterr().out.splitlines()
    stages = [json.loads(x).get("stage") for x in lines]
    assert stages.count("data") == 2 and stages.count("done") == 2
    assert "checkpoints_saved" in stages
    assert _hashes(_CKPT) == before
