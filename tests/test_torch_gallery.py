"""The port's dense store, dedup, AutoGallery and native module
(device="cpu") vs the JAX package's, on the same seeded numpy inputs and
the same call sequences.

Tolerances: ids, hit lists, pairs and groups equal; scores within 1e-5
(1e-6 for the dense store's f32 matmul); files written by either package
restore in the other.
"""
import json
import os

import numpy as np
import pytest
import torch

from scrfd_arcface_facerecognition_tpu import gallery as jgal
from scrfd_arcface_facerecognition_tpu.runtime import native as jnative
from scrfd_arcface_facerecognition_tpu_torch import gallery as tgal
from scrfd_arcface_facerecognition_tpu_torch.ops import (
    cosine_matrix, compute_similarity, top_k_matches)
from scrfd_arcface_facerecognition_tpu_torch.runtime import native as tnative
from torch_cores import shared_cores  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("shared_cores")


def _rows(rng, n, d=64):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _identity_rows(rng, n_ident, per, d=64, sigma=0.03):
    centers = _rows(rng, n_ident, d)
    rows = np.repeat(centers, per, axis=0)
    rows = rows + sigma * rng.normal(size=rows.shape).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows, centers


def _same_hits(want, got, atol=1e-5):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert [h.id for h in g] == [h.id for h in w]
        assert [h.payload for h in g] == [h.payload for h in w]
        np.testing.assert_allclose([h.score for h in g],
                                   [h.score for h in w], atol=atol)


# ------------------------------------------------------------ native module


def test_native_copy_matches_original(tmp_path):
    rng = np.random.default_rng(0)
    pairs = np.asarray([[0, 3], [3, 5], [6, 2], [1, 1]], np.int64)
    for n, p in ((7, pairs), (3, np.zeros((0, 2), np.int64))):
        np.testing.assert_array_equal(tnative.uf_group_roots(n, p),
                                      jnative.uf_group_roots(n, p))
    emb = rng.normal(size=(5, 16)).astype(np.float32)
    ids = np.asarray([9, 3, 12, 0, 7], np.int64)
    for writer, reader in ((tnative, jnative), (jnative, tnative)):
        path = str(tmp_path / f"{writer.__name__}.bin")
        writer.snapshot_write(path, emb, ids)
        e2, i2 = reader.snapshot_read(path)
        np.testing.assert_array_equal(e2, emb)
        np.testing.assert_array_equal(i2, ids)
    assert tnative.native_available() == jnative.native_available()


def test_native_copy_without_library_matches_original(tmp_path, monkeypatch):
    """Both packages without the library: the same Python union-find and
    the same npz snapshot container, each readable by the other."""
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    pairs = np.asarray([[4, 1], [1, 0], [2, 3]], np.int64)
    np.testing.assert_array_equal(tnative.uf_group_roots(6, pairs),
                                  jnative.uf_group_roots(6, pairs))
    emb = np.random.default_rng(1).normal(size=(3, 8)).astype(np.float32)
    ids = np.asarray([5, 1, 2], np.int64)
    for writer, reader in ((tnative, jnative), (jnative, tnative)):
        path = str(tmp_path / f"{writer.__name__}.npz.bin")
        writer.snapshot_write(path, emb, ids)
        with np.load(path) as z:
            assert sorted(z.files) == ["embeddings", "ids"]
        e2, i2 = reader.snapshot_read(path)
        np.testing.assert_array_equal(e2, emb)
        np.testing.assert_array_equal(i2, ids)


# -------------------------------------------------------------- similarity


def test_similarity_ops_match_jax():
    import jax.numpy as jnp
    from scrfd_arcface_facerecognition_tpu import ops as jops

    rng = np.random.default_rng(2)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    g = rng.normal(size=(12, 32)).astype(np.float32)
    g[7] = g[2]                               # exact tie: lower index first
    q[4] = g[2]
    np.testing.assert_allclose(
        float(compute_similarity(torch.from_numpy(q[0]),
                                 torch.from_numpy(g[0]))),
        float(jops.compute_similarity(jnp.asarray(q[0]), jnp.asarray(g[0]))),
        atol=1e-6)
    for normalized in (False, True):
        np.testing.assert_allclose(
            cosine_matrix(torch.from_numpy(q), torch.from_numpy(g),
                          normalized).numpy(),
            np.asarray(jops.cosine_matrix(jnp.asarray(q), jnp.asarray(g),
                                          normalized)), rtol=1e-6, atol=1e-6)
    for k in (3, 20):
        ts, ti = top_k_matches(torch.from_numpy(q), torch.from_numpy(g), k)
        js, ji = jops.top_k_matches(jnp.asarray(q), jnp.asarray(g), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


# -------------------------------------------------------------- dense store


def _dense_pair(capacity=4, d=64):
    return (jgal.GalleryStore(vector_size=d, capacity=capacity),
            tgal.GalleryStore(vector_size=d, capacity=capacity,
                              device="cpu"))


def test_dense_store_call_sequence_matches_jax():
    """Upserts, last-duplicate-wins batches, non-finite refusals, growth,
    updates, deletes with row reuse, payloads and searches."""
    rng = np.random.default_rng(3)
    vecs = _rows(rng, 30)
    stores = _dense_pair()
    for s in stores:
        for i in range(5):
            assert s.add_embedding(100 + i, vecs[i] * 3.0, {"n": i})
        bad = vecs[5].copy()
        bad[2] = np.nan
        assert not s.add_embedding(200, bad)
        ids = [300, 301, 100, 302, 300, 303, 304]
        mat = vecs[6:13].copy()
        mat[3, 0] = np.inf                     # dropped row
        assert s.add_batch(ids, mat, [{"b": i} for i in range(7)]) == 5
        assert s.update_embedding(301, vecs[26])
        assert not s.update_embedding(999, vecs[26])
        assert s.delete_embedding(102)
        assert not s.delete_embedding(102)
        s.add_batch(np.arange(400, 412), vecs[13:25])   # grows
    (js, ts) = stores
    assert ts.capacity == js.capacity
    assert ts.ids() == js.ids()
    assert ts.get_embedding_count() == js.get_embedding_count()
    for pid in js.ids():
        np.testing.assert_allclose(ts.get_embedding(pid),
                                   js.get_embedding(pid), atol=1e-7)
        assert ts.get_payload(pid) == js.get_payload(pid)
    np.testing.assert_array_equal(ts.dense_matrix()[0], js.dense_matrix()[0])
    q = np.concatenate([vecs[[0, 9, 20, 26]], _rows(rng, 3)])
    for k, thr in ((3, None), (40, None), (5, 0.2)):
        _same_hits(js.search_batch(q, k=k, threshold=thr),
                   ts.search_batch(q, k=k, threshold=thr), atol=1e-6)
    _same_hits([js.search_similar(vecs[4], k=2)],
               [ts.search_similar(vecs[4], k=2)], atol=1e-6)
    with pytest.raises(ValueError):
        ts.add_batch([1, 2], vecs[:2], [{}])
    # with a non-finite row dropped too (the reference's store.py:152
    # indexes the short list and raises IndexError here)
    mat = vecs[:3].copy()
    mat[1, 0] = np.nan
    for short_or_long in ([{}], [{}] * 4):
        with pytest.raises(ValueError, match="payloads"):
            ts.add_batch([1, 2, 3], mat, short_or_long)
    assert ts.add_batch([1, 2], np.zeros((2, 7), np.float32)) == 0
    assert ts.clear_all() and js.clear_all()
    assert ts.search_similar(vecs[0], k=3) == [] == js.search_similar(
        vecs[0], k=3)


def test_dense_tie_order_and_nan_query_match_jax():
    """Duplicated rows score equal: the lower row comes first in both. A
    NaN query ranks its NaN similarities last: no hits in either."""
    rng = np.random.default_rng(4)
    base = _rows(rng, 4)
    rows = np.concatenate([np.repeat(base[:1], 5, 0), base[1:],
                           np.repeat(base[1:2], 3, 0)])
    ids = [50, 10, 40, 20, 30, 1, 2, 3, 60, 70, 5]
    js, ts = _dense_pair(capacity=16)
    for s in (js, ts):
        s.add_batch(ids, rows)
        s.delete_embedding(40)
    want = js.search_batch(base[:2], k=6)
    got = ts.search_batch(base[:2], k=6)
    _same_hits(want, got, atol=1e-6)
    assert [h.id for h in got[0][:4]] == [50, 10, 20, 30]
    nan_q = base[:1].copy()
    nan_q[0, 5] = np.nan
    assert ts.search_batch(nan_q, k=3) == [[]] == js.search_batch(nan_q, k=3)


def test_dense_snapshots_cross_packages(tmp_path):
    """Full and incremental snapshots (base + deltas with deletes, clears
    and overwrites, then compaction) written by either package restore in
    the other to the same rows, ids and payloads."""
    rng = np.random.default_rng(5)
    vecs = _rows(rng, 12)
    stores = _dense_pair(capacity=16)
    for s in stores:
        for i in range(6):
            s.add_embedding(i, vecs[i], {"name": f"p{i}"})
    for mod, s in (("j", stores[0]), ("t", stores[1])):
        d = str(tmp_path / f"inc_{mod}")
        s.snapshot(str(tmp_path / f"full_{mod}.bin"))
        s.snapshot_incremental(d)
        s.add_embedding(6, vecs[6], {"name": "p6"})
        s.add_embedding(2, vecs[7], {"name": "p2v2"})
        s.delete_embedding(3)
        s.snapshot_incremental(d)
    for mod, cls, kw in (("j", tgal.GalleryStore, {"device": "cpu"}),
                         ("t", jgal.GalleryStore, {})):
        full = cls.restore(str(tmp_path / f"full_{mod}.bin"), **kw)
        assert sorted(full.ids()) == list(range(6))
        assert full.get_payload(4) == {"name": "p4"}
        live = stores[0]
        back = cls.restore_dir(str(tmp_path / f"inc_{mod}"), **kw)
        assert sorted(back.ids()) == sorted(live.ids())
        assert back.get_payload(2) == {"name": "p2v2"}
        # restore normalizes the rows again: 1-ulp changes
        np.testing.assert_allclose(back.dense_matrix()[0],
                                   live.dense_matrix()[0], atol=1e-6)
        cls.compact_snapshots(str(tmp_path / f"inc_{mod}"), **kw)
        with open(os.path.join(str(tmp_path / f"inc_{mod}"),
                               "MANIFEST.json")) as f:
            assert json.load(f)["deltas"] == []
    # the other package reads the compacted directories too
    for mod, cls, kw in (("t", tgal.GalleryStore, {"device": "cpu"}),
                         ("j", jgal.GalleryStore, {})):
        back = cls.restore_dir(str(tmp_path / f"inc_{mod}"), **kw)
        assert sorted(back.ids()) == sorted(stores[0].ids())


# -------------------------------------------------------------------- dedup


def test_dedup_matches_jax():
    rng = np.random.default_rng(6)
    rows, _ = _identity_rows(rng, 30, 3, sigma=0.01)
    ids = [int(i) * 3 + 7 for i in range(len(rows))]
    np.testing.assert_allclose(
        tgal.all_pairs_similarity(rows, device="cpu"),
        jgal.all_pairs_similarity(rows), atol=1e-6)
    assert tgal.all_pairs_similarity(
        np.zeros((0, 64), np.float32), device="cpu").shape == (0, 0)
    want = jgal.find_duplicate_pairs(rows, 0.9, ids)
    got = tgal.find_duplicate_pairs(rows, 0.9, ids, device="cpu")
    assert [p[:2] for p in got] == [p[:2] for p in want] and want
    np.testing.assert_allclose([p[2] for p in got], [p[2] for p in want],
                               atol=1e-6)
    for block_above in (8192, 10):
        assert (tgal.duplicate_groups(rows, 0.9, ids, block_above=block_above,
                                      device="cpu")
                == jgal.duplicate_groups(rows, 0.9, ids,
                                         block_above=block_above))
    assert tgal.duplicate_groups(np.zeros((0, 64), np.float32), 0.9,
                                 device="cpu") == []


@pytest.mark.parametrize("n_ident,per,block,k_nb", [(40, 4, 32, 16),
                                                    (3, 24, 16, 8)])
def test_blocked_dedup_matches_jax(n_ident, per, block, k_nb):
    """The blocked scan, including rows whose whole top-k cleared the
    threshold and are rescanned at full width (3 x 24 with k=8)."""
    rng = np.random.default_rng(n_ident)
    rows, _ = _identity_rows(rng, n_ident, per, sigma=0.01)
    want = jgal.find_duplicate_pairs_blocked(rows, 0.9, block=block,
                                             k_neighbors=k_nb)
    got = tgal.find_duplicate_pairs_blocked(rows, 0.9, block=block,
                                            k_neighbors=k_nb, device="cpu")
    assert [p[:2] for p in got] == [p[:2] for p in want]
    np.testing.assert_allclose([p[2] for p in got], [p[2] for p in want],
                               atol=1e-6)
    one_shot = sorted(p[:2] for p in jgal.find_duplicate_pairs(rows, 0.9))
    assert sorted(p[:2] for p in got) == one_shot


def test_union_find_merges_into_smaller_id():
    uf = tgal.dedup.UnionFind([9, 4, 7, 2])
    uf.union(9, 7)
    uf.union(7, 4)
    assert uf.find(9) == 4 and uf.find(2) == 2


# -------------------------------------------------------------- AutoGallery


def _auto_pair(**kw):
    return (jgal.AutoGallery(vector_size=64, pq_m=16, **kw),
            tgal.AutoGallery(vector_size=64, pq_m=16, device="cpu", **kw))


def _same_state(jg, tg, queries, k=4):
    assert tg.tier == jg.tier
    assert sorted(tg.ids()) == sorted(jg.ids())
    assert tg.get_embedding_count() == jg.get_embedding_count()
    for pid in jg.ids():
        assert tg.get_payload(pid) == jg.get_payload(pid)
    _same_hits(jg.search_batch(queries, k=k), tg.search_batch(queries, k=k))


def test_auto_sync_migration_and_pq_tier_ops_match_jax():
    """Migration at the threshold, then upsert, delete, growth past the PQ
    capacity and clear on the PQ tier, with duplicate-group worklists."""
    rng = np.random.default_rng(7)
    rows, centers = _identity_rows(rng, 20, 3, sigma=0.02)
    q = centers[:6] + 0.02 * rng.normal(size=(6, 64)).astype(np.float32)
    jg, tg = _auto_pair(tier="auto", pq_threshold=24, min_train_rows=8)
    for g in (jg, tg):
        for i in range(23):
            g.add_embedding(i, rows[i], {"n": i})
        assert g.tier == "dense"
    _same_state(jg, tg, q)
    for g in (jg, tg):
        g.add_batch(np.arange(23, 60), rows[23:60])
        assert g.tier == "pq"
    _same_state(jg, tg, q)
    more = _rows(rng, 200)
    for g in (jg, tg):
        assert g.update_embedding(3, rows[0])
        assert g.delete_embedding(5) and not g.delete_embedding(5)
        g.add_embedding(7, rows[1], {"k": "new"})
        g.add_batch(np.arange(1000, 1200), more)     # past capacity 1024?
        g.add_batch([3, 1000], more[:2], [{"a": 1}, {"a": 2}])
    assert tg._pq.capacity == jg._pq.capacity
    _same_state(jg, tg, np.concatenate([q, more[:3]]), k=6)
    assert tg.duplicate_groups(0.9) == jg.duplicate_groups(0.9)
    for g in (jg, tg):
        assert g.clear_all()
        assert g.tier == "dense" and g.get_embedding_count() == 0


def test_auto_forced_pq_grows_past_capacity_like_jax():
    rng = np.random.default_rng(8)
    jg, tg = _auto_pair(tier="pq", min_train_rows=4)
    rows = _rows(rng, 4)
    for g in (jg, tg):
        g.add_batch(np.arange(4), rows)
    cap = tg._pq.capacity
    assert cap == jg._pq.capacity
    more = _rows(rng, cap + 10)
    for g in (jg, tg):
        g.add_batch(np.arange(100, 100 + cap + 10), more)
    assert tg._pq.capacity == jg._pq.capacity > cap
    _same_state(jg, tg, more[:4], k=3)


def _wait_bg(g, timeout=60):
    t = g._bg_thread
    if t is not None:
        t.join(timeout=timeout)
        assert not t.is_alive(), "background migration did not finish"


def test_auto_async_migration_reconciles_like_jax():
    """Mutations during the background build survive the swap; the swapped
    tier answers as the JAX one does after the same calls."""
    rng = np.random.default_rng(9)
    rows, centers = _identity_rows(rng, 16, 4, sigma=0.02)
    ids = np.arange(len(rows)) * 3 + 1
    extra = _rows(rng, 2)
    jg, tg = _auto_pair(tier="pq", min_train_rows=16, migrate_async=True)
    for g in (jg, tg):
        g.add_batch(ids, rows, [{"i": int(i)} for i in ids])
        assert g.tier == "dense" and g._bg_thread is not None
        assert g.search_similar(rows[2], k=1)[0].id == ids[2]
        g.add_batch([1001, 1002], extra, [{"i": 1001}, {"i": 1002}])
        g.update_embedding(int(ids[0]), rows[5], {"i": -5})
        g.delete_embedding(int(ids[1]))
        _wait_bg(g)
        assert g.get_embedding_count() == len(ids) + 1
        assert g.tier == "pq"
    np.testing.assert_allclose(tg.get_embedding(int(ids[0])), rows[5],
                               atol=1e-6)
    _same_state(jg, tg, np.concatenate([rows[[7, 20]], extra]), k=3)


def test_auto_async_migration_concurrent_readers_survive_swap():
    """Readers on other threads while this one mutates and the background
    build swaps tiers: no reader sees a half-torn state, no update is lost
    (a short switch interval makes the threads interleave often)."""
    import sys
    import threading

    rng = np.random.default_rng(13)
    rows = _rows(rng, 64)
    g = tgal.AutoGallery(vector_size=64, pq_m=16, tier="pq",
                         min_train_rows=32, migrate_async=True, device="cpu")
    g.add_batch(np.arange(32), rows[:32])
    assert g._bg_thread is not None
    errs = []
    stop = threading.Event()

    def reader():
        try:
            while not stop.is_set():
                assert g.get_embedding_count() >= 32
                hits = g.search_similar(rows[0], k=1)
                assert hits and hits[0].id == 0
        except BaseException as e:   # noqa: BLE001 - reported below
            errs.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    readers = [threading.Thread(target=reader) for _ in range(12)]
    try:
        for t in readers:
            t.start()
        for i in range(32, 64):
            g.add_embedding(i, rows[i], {"i": i})
        _wait_bg(g)
        g.get_embedding_count()          # the swap happens here
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in readers)
    assert not errs, errs
    assert g.tier == "pq" and g.get_embedding_count() == 64
    assert g.get_payload(50) == {"i": 50}
    assert g.search_similar(rows[50], k=1)[0].id == 50


def test_auto_async_migration_abandoned_by_clear():
    rng = np.random.default_rng(10)
    rows = _rows(rng, 24)
    g = tgal.AutoGallery(vector_size=64, pq_m=16, tier="pq",
                         min_train_rows=16, migrate_async=True, device="cpu")
    g.add_batch(np.arange(24), rows)
    t = g._bg_thread
    assert t is not None
    g.clear_all()
    assert g.tier == "dense" and g.get_embedding_count() == 0
    t.join(timeout=60)
    assert not t.is_alive()
    g.add_batch(np.arange(4), rows[:4])
    assert g.get_embedding_count() == 4 and g.tier == "dense"


def test_auto_snapshots_cross_packages(tmp_path):
    """Both tiers' snapshots restore in the other package, sniffed by
    format; a PQ snapshot refuses a forced-dense restore; damaged and alien
    files fail loudly."""
    rng = np.random.default_rng(11)
    rows = _rows(rng, 10)
    made = {}
    for tier, kw in (("dense", {}), ("pq", {"min_train_rows": 4})):
        for mod, g in zip("jt", _auto_pair(tier=tier, **kw)):
            g.add_batch(np.arange(10), rows, [{"i": i} for i in range(10)])
            path = str(tmp_path / f"{tier}_{mod}.bin")
            g.snapshot(path)
            made[tier, mod] = g
    for (tier, mod), g in made.items():
        path = str(tmp_path / f"{tier}_{mod}.bin")
        assert tgal.AutoGallery._snapshot_tier(path) == tier
        other = (tgal.AutoGallery, {"device": "cpu"}) if mod == "j" else (
            jgal.AutoGallery, {})
        r = other[0].restore(path, vector_size=64, pq_m=16, tier=tier,
                             min_train_rows=4, **other[1])
        assert r.tier == tier and r.get_embedding_count() == 10
        assert r.get_payload(7) == {"i": 7}
        _same_hits(g.search_batch(rows[[7, 2]], k=3),
                   r.search_batch(rows[[7, 2]], k=3))
    with pytest.raises(ValueError, match="tier='dense'"):
        tgal.AutoGallery.restore(str(tmp_path / "pq_j.bin"), vector_size=64,
                                 pq_m=16, tier="dense", device="cpu")
    full = str(tmp_path / "pq_t.bin")
    cut = str(tmp_path / "cut.bin")
    with open(full, "rb") as f, open(cut, "wb") as g:
        g.write(f.read()[: os.path.getsize(full) // 2])
    with pytest.raises(ValueError, match="damaged|truncated"):
        tgal.AutoGallery.restore(cut, device="cpu")
    alien = str(tmp_path / "alien.bin")
    with open(alien, "wb") as f:
        f.write(b"definitely not a snapshot")
    with pytest.raises(ValueError, match="not a gallery snapshot"):
        tgal.AutoGallery.restore(alien, device="cpu")


def test_auto_nonfinite_rows_on_both_tiers_match_jax():
    """The dense tier refuses non-finite rows. On the PQ tier add_batch
    stores them (a known reference fault, kept for parity): both packages
    then rank the NaN row as the JAX package does."""
    rng = np.random.default_rng(12)
    rows = _rows(rng, 8)
    bad = rows[0].copy()
    bad[0] = np.nan
    jg, tg = _auto_pair(tier="pq", min_train_rows=4)
    for g in (jg, tg):
        assert not g.add_embedding(1, bad)
        assert g.get_embedding_count() == 0
        g.add_batch(np.arange(8), rows)
        assert g.tier == "pq"
        g.add_batch([50], bad[None])
        assert g.get_embedding_count() == 9
    _same_state(jg, tg, rows[[1, 3]], k=9)
    with pytest.raises(ValueError, match=">= 0"):
        tg.add_embedding(-1, rows[0])
    with pytest.raises(ValueError, match="divisible"):
        tgal.AutoGallery(vector_size=200, device="cpu")
    assert tgal.AutoGallery(vector_size=200, tier="dense",
                            device="cpu").tier == "dense"


def test_auto_on_a_mesh_migrates_grows_and_restores_like_jax(tmp_path):
    """AutoGallery(mesh=) over 8 CPU slots against the JAX one over 8
    virtual devices: the migration, growth past the PQ capacity, upserts
    and deletes leave the same state and hits (scores within 1e-5) on
    queries near the enrolled identities (the reranked shortlist of the
    JAX scan's f32 LUT and the port's bf16 one agree there); the
    PQ tier's codes are sharded over the slots; its snapshot restores
    unsharded and back onto the mesh with the same hits."""
    import jax
    from scrfd_arcface_facerecognition_tpu import parallel as jpar
    from scrfd_arcface_facerecognition_tpu_torch import parallel as tpar

    jm = jpar.make_mesh((8,), ("model",), devices=jax.devices()[:8])
    tm = tpar.make_mesh((8,), ("model",),
                        devices=tpar.device_slots("cpu", 8))
    rng = np.random.default_rng(12)
    rows, centers = _identity_rows(rng, 20, 3, sigma=0.02)
    q = centers[:6] + 0.02 * rng.normal(size=(6, 64)).astype(np.float32)
    jg = jgal.AutoGallery(vector_size=64, pq_m=16, tier="pq",
                          min_train_rows=8, mesh=jm)
    tg = tgal.AutoGallery(vector_size=64, pq_m=16, tier="pq",
                          min_train_rows=8, mesh=tm, device="cpu")
    more = _rows(rng, 1100)
    for g in (jg, tg):
        g.add_batch(np.arange(60), rows[:60])
        assert g.tier == "pq"
        g.add_batch(np.arange(1000, 2100), more)      # past capacity 1024
        assert g.update_embedding(3, rows[0]) and g.delete_embedding(5)
    assert tg._pq.capacity == jg._pq.capacity
    assert len(tg._pq._shards.rows) == 8 and tg._pq.mesh is tm
    _same_state(jg, tg, q, k=6)
    assert [h[0].id for h in tg.search_batch(more[:3], k=1)] == [
        1000, 1001, 1002]
    path = str(tmp_path / "pq.npz")
    tg.snapshot(path)
    for mesh in (None, tm):
        r = tgal.AutoGallery.restore(path, vector_size=64, pq_m=16,
                                     tier="pq", mesh=mesh, device="cpu")
        assert r.tier == "pq" and (r._pq.mesh is mesh)
        _same_state(jg, r, q, k=6)
