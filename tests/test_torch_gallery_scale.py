"""The port's gallery-scale tools against the JAX repository's tools of
the same names (``tools/exp_merge_1m.py``, ``exp_train_budget.py``,
``exp_migration.py``, ``exp_pq_scale.py``), on the CPU, on the same seeds,
at small sizes.

The JAX tools are loaded from ``tools/`` by path and run through their
``main`` (argv replaced, their JSON lines read back) or their functions;
what they hand the JAX gallery (rows, queries, codecs, pairs) is caught by
wrapping the JAX gallery's functions. Tolerances:

- the seeded rows, queries and planted pairs: bit-equal;
- the duplicate pairs and the union-find roots: equal;
- the migration, sync and async: the tier reached and top-1 self equal;
- the train budget: each rung's top-1 identity equal, the JAX codec's
  centroids carried across (``PQCodec.from_centroids``), and equal with
  the port's own k-means on the cheapest rung;
- the PQ scale: with the JAX codecs carried across, every search's ids
  equal ("hilo" against the JAX scan, "hi" against the JAX Pallas kernel
  in interpret mode, the same bf16 sums) and its scores within 1e-5,
  recall@k and top-1 same identity equal. The whole tools, each training
  its own 100,000-row codecs, are compared in a slow test: top-1 same
  identity equal, recall@k within 0.05 (k-means' sum order may move a
  code).

Every JSON line of a port tool carries the JAX tool's keys, the metric
names equal apart from the kernel's name (``pq_adc`` where JAX printed its
``adc_impl``).
"""
import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from scrfd_arcface_facerecognition_tpu.gallery import dedup as jdedup
from scrfd_arcface_facerecognition_tpu.gallery import pq as jpq
from scrfd_arcface_facerecognition_tpu.runtime import native as jnative
from scrfd_arcface_facerecognition_tpu_torch.gallery import dedup as tdedup
from scrfd_arcface_facerecognition_tpu_torch.gallery import pq as tpq
from scrfd_arcface_facerecognition_tpu_torch.tools import (
    exp_merge_1m, exp_migration, exp_pq_scale, exp_train_budget)
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """The JAX repository's ``tools/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(_REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_main(monkeypatch, capsys, name, argv):
    """(exit code, JSON lines) of a JAX tool's main on ``argv``."""
    mod = _jax_tool(name)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    rc = mod.main()
    out = capsys.readouterr().out
    return rc, [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def _bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _same_keys(jax_lines, port_lines):
    assert len(jax_lines) == len(port_lines)
    for j, t in zip(jax_lines, port_lines):
        assert set(j) <= set(t), (j, t)


# ------------------------------------------------------------ exp_merge_1m


def test_merge_tool_matches_jax(monkeypatch, capsys):
    """Three row blocks (G=10,000 at block 4096), planted pairs across
    them: the rows bit-equal, the pairs, the union-find roots and every
    printed figure but the seconds equal."""
    seen = {}
    scan, groups = jdedup.find_duplicate_pairs_blocked, jnative.uf_group_roots

    def jax_scan(rows, threshold, *a, **k):
        seen["rows"] = rows.copy()
        seen["pairs"] = scan(rows, threshold, *a, **k)
        return seen["pairs"]

    def jax_groups(n, pairs):
        seen["roots"] = groups(n, pairs)
        return seen["roots"]

    monkeypatch.setattr(jdedup, "find_duplicate_pairs_blocked", jax_scan)
    monkeypatch.setattr(jnative, "uf_group_roots", jax_groups)
    rc, jax_lines = _jax_main(monkeypatch, capsys, "exp_merge_1m",
                              ["--g", "10000", "--dups", "40"])
    port_lines = []
    res = exp_merge_1m.run(10_000, 40, 0.95, device="cpu",
                           emit=port_lines.append)
    rows, n_unique = exp_merge_1m.planted_rows(10_000, 40)
    _bit_equal(rows, seen["rows"])
    assert n_unique == 9960
    assert res["pairs"] == {(a, b) for a, b, _ in seen["pairs"]}
    assert res["pairs"] == {(i, 9960 + i) for i in range(40)}
    np.testing.assert_array_equal(res["roots"], seen["roots"])
    _same_keys(jax_lines, port_lines)
    for j, t in zip(jax_lines, port_lines):
        for key in ("note", "metric", "unit", "pairs_found", "exact_match",
                    "groups_after_merge"):
            assert j.get(key) == t.get(key), key
    assert rc == 0 and res["exact_match"]
    assert res["groups_after_merge"] == 10_000 - 40


def test_merge_tool_exits_1_on_a_missed_pair(monkeypatch, capsys):
    scan = tdedup.find_duplicate_pairs_blocked
    monkeypatch.setattr(tdedup, "find_duplicate_pairs_blocked",
                        lambda *a, **k: scan(*a, **k)[1:])
    assert exp_merge_1m.main(["--g", "3000", "--dups", "5",
                              "--device", "cpu"]) == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[1]["exact_match"] is False and lines[1]["pairs_found"] == 4


# -------------------------------------------------------- exp_train_budget


def test_train_budget_tool_matches_jax(monkeypatch, capsys):
    """Every rung through the port's gallery with the JAX codec's
    centroids gives the JAX tool's top-1 identity; the port's own k-means
    too, on the cheapest rung."""
    codecs, queries = [], []
    train, search = jpq.PQCodec.train, jpq.PQGallery.search

    def jax_train(emb, *a, **k):
        codecs.append((np.array(emb), train(emb, *a, **k)))
        return codecs[-1][1]

    def jax_search(self, q, *a, **k):
        queries.append(np.array(q))
        return search(self, q, *a, **k)

    monkeypatch.setattr(jpq.PQCodec, "train", staticmethod(jax_train))
    monkeypatch.setattr(jpq.PQGallery, "search", jax_search)
    rc, jax_lines = _jax_main(monkeypatch, capsys, "exp_train_budget",
                              ["--rows", "1024", "--queries", "32"])
    assert rc == 0 and len(jax_lines) == len(exp_train_budget.LADDER)
    mat, owner, q, q_ident = exp_train_budget.budget_rows(1024, 32)
    for (emb, jc), line, (train_rows, iters) in zip(
            codecs, jax_lines, exp_train_budget.LADDER):
        _bit_equal(emb, mat[:train_rows])
        assert (line["train_rows"], line["iters"]) == (train_rows, iters)
        codec = tpq.PQCodec.from_centroids(np.asarray(jc.centroids), "cpu")
        hit, _ = exp_train_budget.evaluate(codec, mat, owner, q, q_ident)
        assert f"{hit}/32" == line["top1_identity"]
    for got in queries:
        _bit_equal(got, q)
    monkeypatch.setattr(exp_train_budget, "LADDER",
                        exp_train_budget.LADDER[-1:])
    port_lines = []
    out = exp_train_budget.run(1024, 32, "cpu", emit=port_lines.append)
    _same_keys(jax_lines[-1:], port_lines)
    assert out[0]["top1_identity"] == jax_lines[-1]["top1_identity"]


# ----------------------------------------------------------- exp_migration


@pytest.mark.parametrize("n,seed", [(3000, 0), (100, 1)])
def test_migration_rows_equal_jax(n, seed):
    jm = _jax_tool("exp_migration")
    _bit_equal(exp_migration.make_rows(n, seed=seed),
               jm.make_rows(n, seed=seed))


def test_migration_tool_matches_jax():
    """The synchronous and the background crossing at 1,200 rows: both
    packages reach the PQ tier with every query finding itself; the async
    run's probes all answer, and its build does not fail."""
    jm = _jax_tool("exp_migration")
    want = jm.run_scale(1200)
    got = exp_migration.run_scale(1200, device="cpu")
    assert set(want) <= set(got)
    assert got["rows"] == want["rows"] == 1200
    assert got["top1_self"] == want["top1_self"] == "16/16"
    want = jm.run_scale_async(1200, probe_period_s=0.05)
    got = exp_migration.run_scale_async(1200, probe_period_s=0.05,
                                        device="cpu")
    assert set(want) <= set(got)
    assert got["top1_self"] == want["top1_self"] == "16/16"
    assert got["swap_call_s"] is not None and not got["bg_failed"]
    assert got["probe_top1_self_min"] in (None, "16/16")


def test_migration_main_prints_a_summary_on_repeat(capsys):
    assert exp_migration.main(["--rows", "600", "--repeat", "2",
                               "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x.get("summary") for x in lines] == [None, None, "sync"]
    assert lines[2]["runs"] == 2 and lines[0]["top1_self"] == "16/16"


# ------------------------------------------------------------ exp_pq_scale


_SCALE_ARGV = ["--g", "3000", "--q", "4", "--q-sweep", "4", "--k", "5",
               "--chunk", "1000", "--dense-g", "2000"]


def _scale_on_both(monkeypatch, capsys, carry):
    """Both tools on ``_SCALE_ARGV``; every codec they train, every row
    they add and every search (queries, arguments, results) caught. The
    JAX gallery's searches take the scan in "hilo" and the Pallas kernel
    in interpret mode in "hi". With ``carry``, each JAX codec trains on the
    first 2,048 of its rows in 3 iterations and the port uses its
    centroids."""
    seen = dict(jax=dict(train=[], add=[], search=[], codec=[]),
                port=dict(train=[], add=[], search=[]))
    jtrain, jadd, jsearch = (jpq.PQCodec.train, jpq.PQGallery.add,
                             jpq.PQGallery.search)
    ttrain, tadd, tsearch = (tpq.PQCodec.train, tpq.PQGallery.add,
                             tpq.PQGallery.search)

    def jax_train(emb, *a, **k):
        seen["jax"]["train"].append(np.array(emb))
        c = (jtrain(emb[:2048], m=k.get("m", 64), iters=3) if carry
             else jtrain(emb, *a, **k))
        seen["jax"]["codec"].append(np.asarray(c.centroids))
        return c

    def jax_search(self, q, k=5, rerank=0, precision=None):
        prec = precision or ("hi" if rerank else "hilo")
        self.adc_impl = "mxu" if prec == "hi" else "scan"
        out = jsearch(self, q, k=k, rerank=rerank, precision=precision)
        seen["jax"]["search"].append((np.array(q), (k, rerank, prec), out))
        return out

    def port_train(emb, *a, **k):
        seen["port"]["train"].append(np.array(emb))
        if not carry:
            return ttrain(emb, *a, **k)
        i = len(seen["port"]["train"]) - 1
        return tpq.PQCodec.from_centroids(seen["jax"]["codec"][i],
                                          k.get("device"))

    def port_search(self, q, k=5, rerank=0, precision=None):
        out = tsearch(self, q, k=k, rerank=rerank, precision=precision)
        prec = precision or ("hi" if rerank else "hilo")
        seen["port"]["search"].append((np.array(q), (k, rerank, prec), out))
        return out

    def adder(real, side):
        def add(self, ids, emb):
            seen[side]["add"].append(np.array(emb))
            return real(self, ids, emb)
        return add

    monkeypatch.setattr(jpq.PQCodec, "train", staticmethod(jax_train))
    monkeypatch.setattr(jpq.PQGallery, "add", adder(jadd, "jax"))
    monkeypatch.setattr(jpq.PQGallery, "search", jax_search)
    monkeypatch.setattr(tpq.PQCodec, "train", staticmethod(port_train))
    monkeypatch.setattr(tpq.PQGallery, "add", adder(tadd, "port"))
    monkeypatch.setattr(tpq.PQGallery, "search", port_search)
    rc, jax_lines = _jax_main(monkeypatch, capsys, "exp_pq_scale",
                              _SCALE_ARGV)
    assert rc is None
    assert exp_pq_scale.main(_SCALE_ARGV + ["--device", "cpu"]) == 0
    port_lines = [json.loads(x)
                  for x in capsys.readouterr().out.splitlines()]
    return seen, jax_lines, port_lines


def _runs(searches):
    """Consecutive searches of the same queries and arguments as one:
    (queries, arguments, result, count), every result of a run equal."""
    out = []
    for q, args, (sc, ids) in searches:
        if out and out[-1][1] == args and np.array_equal(out[-1][0], q):
            np.testing.assert_array_equal(ids, out[-1][2][1])
            np.testing.assert_array_equal(sc, out[-1][2][0])
            out[-1][3] += 1
        else:
            out.append([q, args, (sc, ids), 1])
    return out


def _hold_lines(jax_lines, port_lines, recall_tol=0.0):
    _same_keys(jax_lines, port_lines)
    for j, t in zip(jax_lines, port_lines):
        if "metric" not in j:
            assert j == t
            continue
        assert re.sub(r"(scan|mxu)/", "pq_adc/", j["metric"]) == t["metric"]
        if j["unit"] == "recall":
            assert t["top1_same_identity"] == j["top1_same_identity"]
            assert abs(t["value"] - j["value"]) <= recall_tol


def test_pq_scale_tool_matches_jax_with_the_codecs_carried(monkeypatch,
                                                          capsys):
    seen, jax_lines, port_lines = _scale_on_both(monkeypatch, capsys, True)
    j, t = seen["jax"], seen["port"]
    for what in ("train", "add"):
        assert len(j[what]) == len(t[what]) > 1
        for a, b in zip(j[what], t[what]):
            _bit_equal(a, b)
    # the sweep's searches in each precision (the port's one more, its
    # stage split), then the recall study's two
    jg, tg = _runs(j["search"]), _runs(t["search"])
    assert [n for *_, n in jg] == [6, 6, 1, 1]
    assert [n for *_, n in tg] == [7, 7, 1, 1]
    for (jq, jargs, (js, ji), _), (tq, targs, (ts, ti), _) in zip(jg, tg):
        _bit_equal(jq, tq)
        assert jargs == targs
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-5)
    assert [a[2] for _, a, _, _ in tg] == ["hilo", "hi", "hilo", "hi"]
    _hold_lines(jax_lines, port_lines)


@pytest.mark.slow
def test_pq_scale_whole_tool_matches_jax(monkeypatch, capsys):
    """Each tool trains its own 100,000-row codecs (the JAX tool's
    hard-coded size): the rows bit-equal, top-1 same identity equal,
    recall@k within 0.05."""
    seen, jax_lines, port_lines = _scale_on_both(monkeypatch, capsys, False)
    for what in ("train", "add"):
        for a, b in zip(seen["jax"][what], seen["port"][what]):
            _bit_equal(a, b)
    _hold_lines(jax_lines, port_lines, recall_tol=0.05)


def test_pq_scale_dense_search_is_the_stores_top_k():
    """The dense comparison search ranks as ``GalleryStore`` does: f32
    products, ties to the lower row."""
    from scrfd_arcface_facerecognition_tpu_torch.gallery import GalleryStore

    rng = np.random.default_rng(3)
    rows = exp_pq_scale.unit_rows(rng, 300)
    rows[7] = rows[3]
    q = rows[[3, 10, 11]]
    s, i = exp_pq_scale.dense_search(torch.from_numpy(q),
                                     torch.from_numpy(rows), 4)
    store = GalleryStore(capacity=300, device="cpu")
    store.add_batch(np.arange(300), rows)
    hits = store.search_batch(q, k=4)
    assert [[h.id for h in x] for x in hits] == i.tolist()
    assert i[0, :2].tolist() == [3, 7]


@pytest.mark.parametrize("tool,argv", [
    (exp_merge_1m, ["--g", "100", "--dups", "2"]),
    (exp_train_budget, ["--rows", "128", "--queries", "2"]),
    (exp_migration, ["--rows", "100"]),
    (exp_migration, ["--rows", "100", "--mode", "async"]),
    (exp_pq_scale, ["--g", "100", "--dense-g", "0"])])
def test_tools_run_on_the_card_unless_told_otherwise(monkeypatch, tool,
                                                     argv):
    """Without ``--device cpu`` a tool asks for the card, and without one
    it raises before any work; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
