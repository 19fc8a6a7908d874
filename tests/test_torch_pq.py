"""The port's PQ tier (device="cpu") vs the JAX package's, on the same
seeded numpy inputs.

Tolerances: the port's plain f32 scan against the JAX scan ``adc_scores`` at
rtol 1e-6; against the Pallas kernel ``adc_scores_mxu`` (interpret mode) at
2e-5 of max |score| in "hilo" (its bf16 hi/lo split approximates the f32
LUT) and at 1e-6 in "hi" (the same bf16 sums). Codec: codes equal and
centroids within 1e-5. Searches: ids equal, scores within 1e-5.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from scrfd_arcface_facerecognition_tpu.gallery import pq as jpq
from scrfd_arcface_facerecognition_tpu_torch.gallery import pq as tpq
from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc


def _identity_corpus(n_ids=64, per_id=8, dim=64, seed=0):
    """Clustered unit vectors: per_id noisy copies of n_ids identities."""
    rng = np.random.default_rng(seed)
    ids = rng.normal(size=(n_ids, dim)).astype(np.float32)
    ids /= np.linalg.norm(ids, axis=1, keepdims=True)
    x = np.repeat(ids, per_id, axis=0)
    x += rng.normal(scale=0.05, size=x.shape).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return ids, x


@pytest.fixture(scope="module")
def codecs():
    """The JAX codec and the port's copy of its centroids."""
    _, corpus = _identity_corpus()
    jc = jpq.PQCodec.train(corpus, m=16, k=32, iters=4, seed=0)
    return jc, tpq.PQCodec.from_centroids(np.asarray(jc.centroids), "cpu"), \
        corpus


def _lut_codes(rng, q, m, k, g):
    lut = rng.normal(size=(q, m, k)).astype(np.float32)
    codes = rng.integers(0, k, (g, m)).astype(np.uint8)
    return lut, codes


# ------------------------------------------------------------------ the ADC


@pytest.mark.parametrize("q,m,k,g", [(3, 8, 16, 500), (1, 12, 128, 77),
                                     (5, 64, 256, 300), (2, 16, 32, 0)])
def test_adc_plain_scan_matches_jax_scan(q, m, k, g):
    rng = np.random.default_rng(q * 100 + m)
    lut, codes = _lut_codes(rng, q, m, k, g)
    want = np.asarray(jpq.adc_scores(jnp.asarray(lut), jnp.asarray(codes)))
    got = tpq.adc_scores(torch.from_numpy(lut), torch.from_numpy(codes))
    assert got.shape == (q, g)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("k", [16, 128])
def test_adc_plain_matches_pallas_kernel_interpret(k):
    rng = np.random.default_rng(k)
    codec = jpq.PQCodec(centroids=jnp.asarray(
        rng.normal(size=(8, k, 4)).astype(np.float32)))
    codes = rng.integers(0, k, (300, 8)).astype(np.uint8)
    lut = np.asarray(codec.lut(rng.normal(size=(3, 32)).astype(np.float32)))
    t_lut, t_codes = torch.from_numpy(lut), torch.from_numpy(codes)
    for precision, tol in (("hilo", 2e-5), ("hi", 1e-6)):
        want = np.asarray(jpq.adc_scores_mxu(
            jnp.asarray(lut), jnp.asarray(codes), block_g=128,
            interpret=True, precision=precision))
        got = pq_adc.adc_scores_plain(t_lut, t_codes, precision).numpy()
        scale = float(np.abs(got).max())
        assert float(np.abs(got - want).max()) <= tol * scale, precision


def test_adc_nonfinite_lut_entries_propagate_as_the_scan():
    rng = np.random.default_rng(7)
    lut, codes = _lut_codes(rng, 3, 8, 16, 200)
    lut[0] = np.nan                        # a non-finite query
    lut[1, 2, 5] = np.inf
    lut[1, 3, 6] = -np.inf                 # inf + -inf -> NaN where both hit
    lut[2, 0, 1] = 3e38                    # overflows to inf in a sum
    lut[2, 1, :] = 3e38
    want = np.asarray(jpq.adc_scores(jnp.asarray(lut), jnp.asarray(codes)))
    for precision in ("hilo", "hi"):
        got = pq_adc.adc_scores_plain(torch.from_numpy(lut),
                                      torch.from_numpy(codes),
                                      precision).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(
        pq_adc.adc_scores_plain(torch.from_numpy(lut),
                                torch.from_numpy(codes)).numpy()[fin],
        want[fin], rtol=1e-6)


def test_k2_wrapper_takes_plain_version_on_cpu_only():
    rng = np.random.default_rng(8)
    lut, codes = _lut_codes(rng, 4, 16, 64, 123)
    t_lut, t_codes = torch.from_numpy(lut), torch.from_numpy(codes)
    before = pq_adc.launches
    for precision in ("hilo", "hi"):
        got = pq_adc.pq_adc_scores(t_lut, t_codes, precision)
        want = pq_adc.adc_scores_plain(t_lut, t_codes, precision)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert pq_adc.launches == before            # no kernel on the CPU
    assert pq_adc.pq_adc_scores(t_lut, t_codes[:0]).shape == (4, 0)
    with pytest.raises(ValueError, match="precision"):
        pq_adc.pq_adc_scores(t_lut, t_codes, "bf16")
    with pytest.raises(ValueError, match="unsupported device"):
        pq_adc.pq_adc_scores(t_lut.to("meta"), t_codes.to("meta"))


# ---------------------------------------------------------------- the codec


@pytest.mark.parametrize("m,k,iters,chunk", [(8, 32, 3, 100),
                                             (16, 16, 2, 4096)])
def test_codec_train_and_encode_match_jax(m, k, iters, chunk):
    _, corpus = _identity_corpus(seed=m)
    jc = jpq.PQCodec.train(corpus, m=m, k=k, iters=iters, seed=3,
                           chunk=chunk)
    tc = tpq.PQCodec.train(corpus, m=m, k=k, iters=iters, seed=3,
                           chunk=chunk, device="cpu")
    np.testing.assert_allclose(tc.centroids.numpy(), np.asarray(jc.centroids),
                               atol=1e-5)
    want = np.asarray(jc.encode(corpus, chunk=100))
    np.testing.assert_array_equal(tc.encode(corpus, chunk=100).numpy(), want)
    np.testing.assert_array_equal(tc.encode(corpus).numpy(), want)


def test_codec_decode_lut_and_k_limit(codecs):
    jc, tc, corpus = codecs
    codes = np.asarray(jc.encode(corpus[:40]))
    np.testing.assert_array_equal(tc.encode(corpus[:40]).numpy(), codes)
    np.testing.assert_allclose(
        tc.decode(torch.from_numpy(codes)).numpy(),
        np.asarray(jc.decode(jnp.asarray(codes))), atol=0)
    np.testing.assert_allclose(tc.lut(corpus[:5]).numpy(),
                               np.asarray(jc.lut(corpus[:5])), atol=1e-6)
    assert tc.lut(corpus[:5]).is_contiguous()
    with pytest.raises(ValueError, match="256"):
        tpq.PQCodec.train(corpus, m=8, k=512, iters=1, device="cpu")
    with pytest.raises(ValueError, match="256"):
        tpq.PQCodec(torch.zeros((8, 300, 8)))


# -------------------------------------------------------------- the gallery


def _both_galleries(codecs, capacity, keep_exact=False):
    jc, tc, _ = codecs
    return (jpq.PQGallery(jc, capacity=capacity, keep_exact=keep_exact),
            tpq.PQGallery(tc, capacity=capacity, keep_exact=keep_exact,
                          device="cpu"))


def _same_search(jg, tg, q, **kw):
    js, ji = jg.search(q, **kw)
    ts, ti = tg.search(q, **kw)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    return ts, ti


@pytest.mark.parametrize("rerank,precision", [(0, None), (8, None),
                                              (8, "hilo")])
def test_pq_gallery_add_delete_search_match_jax(codecs, rerank, precision):
    _, _, corpus = codecs
    jg, tg = _both_galleries(codecs, 200, keep_exact=True)
    ids = np.arange(150) * 3 + 1
    np.testing.assert_array_equal(tg.add(ids, corpus[:150]),
                                  jg.add(ids, corpus[:150]))
    for pid in (4, 31, 448):
        assert tg.delete(pid) == jg.delete(pid)
    assert not tg.delete(999_999)
    # slot reuse after the deletes
    np.testing.assert_array_equal(tg.add([7000, 7001], corpus[200:202]),
                                  jg.add([7000, 7001], corpus[200:202]))
    assert len(tg) == len(jg) == 149
    _same_search(jg, tg, corpus[300:316], k=5, rerank=rerank,
                 precision=precision)


def test_pq_gallery_pads_to_k_and_refuses(codecs):
    _, _, corpus = codecs
    jg, tg = _both_galleries(codecs, 3, keep_exact=True)
    jg.add([5, 6], corpus[:2])
    tg.add([5, 6], corpus[:2])
    s, got = _same_search(jg, tg, corpus[:2], k=5)
    assert got.shape == (2, 5) and (got[:, 2:] == -1).all()
    assert (s[:, 3:] == 0.0).all()
    _same_search(jg, tg, corpus[:2], k=5, rerank=4)
    with pytest.raises(ValueError, match=">= 0"):
        tg.add([-5], corpus[:1])
    with pytest.raises(ValueError, match="full"):
        tg.add([1, 2], corpus[:2])
    plain = tpq.PQGallery(codecs[1], capacity=8, device="cpu")
    plain.add([1], corpus[:1])
    with pytest.raises(ValueError, match="keep_exact"):
        plain.search(corpus[0], k=1, rerank=8)


def test_pq_tie_order_duplicate_codes_and_nan_query(codecs):
    """Rows with the same codes score bit-equal: both packages rank the
    lower slot first. A NaN query scores NaN on every valid row, which
    lax.top_k ranks first (lower slot first): ids come back -1 with score
    0 in both."""
    _, _, corpus = codecs
    jg, tg = _both_galleries(codecs, 64)
    rows = np.concatenate([np.repeat(corpus[:1], 6, 0), corpus[10:20],
                           np.repeat(corpus[1:2], 5, 0)])
    ids = np.arange(len(rows)) * 7 + 2
    jg.add(ids, rows)
    tg.add(ids, rows)
    jg.delete(int(ids[2]))
    tg.delete(int(ids[2]))
    _, got = _same_search(jg, tg, corpus[[0, 1, 2]], k=8)
    assert list(got[0][:5]) == [ids[i] for i in (0, 1, 3, 4, 5)]
    q = corpus[:2].copy()
    q[1, 3] = np.nan
    s, got = _same_search(jg, tg, q, k=4)
    assert (got[1] == -1).all() and (s[1] == 0).all()


def test_pq_snapshots_cross_packages(codecs, tmp_path):
    """Each package restores the other's npz: same search results, adds
    continue after restore."""
    _, _, corpus = codecs
    jg, tg = _both_galleries(codecs, 128, keep_exact=True)
    ids = np.arange(100)
    jg.add(ids, corpus[:100])
    tg.add(ids, corpus[:100])
    jg.delete(17)
    tg.delete(17)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jg.snapshot(jpath)
    tg.snapshot(tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])
    t_from_j = tpq.PQGallery.restore(jpath, device="cpu")
    j_from_t = jpq.PQGallery.restore(tpath)
    assert len(t_from_j) == len(j_from_t) == 99
    q = corpus[200:206]
    # the JAX scan on the CPU sums the f32 LUT whatever the precision, so
    # the shortlist is compared in "hilo"
    for kw in (dict(k=5), dict(k=5, rerank=20, precision="hilo")):
        _same_search(j_from_t, t_from_j, q, **kw)
    np.testing.assert_array_equal(t_from_j.add([999], corpus[300:301]),
                                  j_from_t.add([999], corpus[300:301]))


@pytest.mark.slow
def test_full_width_pq_parity():
    """M=64, K=256, dim 512, 4096 rows: the JAX codec's centroids carried
    across, codes equal, reranked and plain searches equal."""
    _, corpus = _identity_corpus(n_ids=512, per_id=8, dim=512, seed=5)
    jc = jpq.PQCodec.train(corpus, m=64, k=256, iters=3, seed=0)
    tc = tpq.PQCodec.train(corpus, m=64, k=256, iters=3, seed=0,
                           device="cpu")
    np.testing.assert_allclose(tc.centroids.numpy(), np.asarray(jc.centroids),
                               atol=1e-5)
    tc = tpq.PQCodec.from_centroids(np.asarray(jc.centroids), "cpu")
    np.testing.assert_array_equal(tc.encode(corpus).numpy(),
                                  np.asarray(jc.encode(corpus)))
    jg = jpq.PQGallery(jc, capacity=8192, keep_exact=True)
    tg = tpq.PQGallery(tc, capacity=8192, keep_exact=True, device="cpu")
    jg.add(np.arange(4096), corpus)
    tg.add(np.arange(4096), corpus)
    q = corpus[::64] + 0.01
    for kw in (dict(k=5), dict(k=5, rerank=32)):
        _same_search(jg, tg, q, **kw)
