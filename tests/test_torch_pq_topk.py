"""The PQ search's top-k fused into kernel K2 (``gallery/pq_adc.py``
``pq_adc_topk``), against the plain chain (``pq_adc.topk_plain``: the
plain scores, invalid rows to -inf, a stable descending top-k) and the
chain it replaces (the same with K2's scores).

On the CPU ``pq_adc_topk`` runs the chain itself; the tests hold it to the
order it promises (NaN first, then the higher score, then the lower row),
the argument checks, and the search's scoring once a shard. The tests
marked ``card`` hold the fused kernel to both chains on an NVIDIA card,
bit for bit, scores and rows, and the dispatch by k there (``python -m
pytest tests/test_torch_pq_topk.py -m card``), and skip elsewhere. This
file imports no JAX, so it runs as it is on the card's machine.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from scrfd_arcface_facerecognition_tpu_torch.gallery import pq as tpq
from scrfd_arcface_facerecognition_tpu_torch.gallery import pq_adc

CASES = ("random", "ties", "invalid", "few_valid", "nan_query")
KS = (1, 5, 32)
QS = (1, 5, 64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def workload(case: str, q: int, g: int, seed: int, m: int = 16,
             k: int = 32):
    """(Q, M, K) f32 LUT, (G, M) u8 codes and (G,) bool validity of one
    case:

    - ``random``: normal LUT entries, uniform codes, every row valid;
    - ``ties``: every row one of three code rows, so equal scores straddle
      every k-th place;
    - ``invalid``: as ``ties`` with about half the rows invalid;
    - ``few_valid``: two valid rows, fewer than most k: the rest rank as
      -inf by row;
    - ``nan_query``: query 0's subspace 1 all NaN (every score NaN), the
      others NaN at one entry (NaN where a row has that code) and +-inf at
      two (inf, -inf and NaN sums), a third of the rows invalid.
    """
    rng = np.random.default_rng(seed)
    lut = rng.normal(size=(q, m, k)).astype(np.float32)
    codes = rng.integers(0, k, (g, m), dtype=np.uint8)
    valid = np.ones(g, bool)
    if case in ("ties", "invalid"):
        codes = codes[:3][rng.integers(0, min(3, g), g)]
    if case == "invalid":
        valid = rng.random(g) < 0.5
    if case == "few_valid":
        valid[:] = False
        valid[rng.choice(g, size=min(2, g), replace=False)] = True
    if case == "nan_query":
        lut[0, 1, :] = np.nan
        lut[1:, 2, 7] = np.nan
        lut[1:, 3, 5] = np.inf
        lut[1:, 4, 6] = -np.inf
        codes[::4, 2] = 7
        codes[::3, 3] = 5
        codes[::5, 4] = 6
        valid = rng.random(g) < 2 / 3
    return (torch.from_numpy(lut), torch.from_numpy(codes),
            torch.from_numpy(valid))


def present(lut, codes, valid, k, precision, row_offset=0):
    """The chain the fused top-k replaces, as the search ran it: K2's
    scores (its plain version on the CPU), invalid rows to -inf, a stable
    descending top-k of min(k, G), rows + row_offset."""
    return pq_adc.topk_plain(lut, codes, valid, k, precision, row_offset,
                             scores=pq_adc.pq_adc_scores)


def assert_as_both_chains(got, lut, codes, valid, k, precision,
                          row_offset=0):
    """``got`` bit-equal to the plain chain (the plain scores, on the
    tensors' device) and to the chain the fused top-k replaces."""
    assert_same(got, pq_adc.topk_plain(lut, codes, valid, k, precision,
                                       row_offset))
    assert_same(got, present(lut, codes, valid, k, precision, row_offset))


def assert_same(got, want):
    """Bit for bit: the rows equal, the scores equal as bits (NaNs at the
    same places)."""
    (gs, gi), (ws, wi) = got, want
    assert gs.shape == ws.shape and gi.shape == wi.shape
    assert gi.dtype == torch.int64 and gs.dtype == torch.float32
    assert torch.equal(gi.cpu(), wi.cpu())
    gs, ws = gs.cpu(), ws.cpu()
    assert torch.equal(gs.isnan(), ws.isnan())
    fin = ~ws.isnan()
    assert torch.equal(gs[fin].view(torch.int32), ws[fin].view(torch.int32))


def order_reference(lut, codes, valid, k, precision):
    """The order the chain promises, by numpy's lexsort: NaN first, then
    the higher score, then the lower row."""
    s = pq_adc.adc_scores_plain(lut, codes, precision).numpy()
    s = np.where(valid.numpy()[None], s, -np.inf)
    rows = np.arange(s.shape[1])
    out_s, out_i = [], []
    for r in s:
        nan = np.isnan(r)
        order = np.lexsort((rows, -np.where(nan, 0, r), ~nan))
        order = order[:min(k, len(r))]
        out_s.append(r[order])
        out_i.append(order)
    return (torch.from_numpy(np.asarray(out_s, np.float32)),
            torch.from_numpy(np.asarray(out_i, np.int64)))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("precision", pq_adc.PRECISIONS)
@pytest.mark.parametrize("case", CASES)
def test_topk_plain_route_equals_the_chain(case, precision, k):
    """On the CPU ``pq_adc_topk`` is the chain, in the chain's order, at
    every Q; no kernel is launched."""
    before = (pq_adc.launches, pq_adc.topk_launches)
    for q in QS:
        for g in (3, 300):
            lut, codes, valid = workload(case, q, g, seed=q * 1000 + g)
            got = pq_adc.pq_adc_topk(lut, codes, valid, k, precision, 7)
            assert_as_both_chains(got, lut, codes, valid, k, precision, 7)
            ref_s, ref_i = order_reference(lut, codes, valid, k, precision)
            assert_same(got, (ref_s, ref_i + 7))
    assert (pq_adc.launches, pq_adc.topk_launches) == before


def test_topk_checks_its_arguments():
    lut, codes, valid = workload("random", 2, 10, seed=1)
    with pytest.raises(ValueError, match="k must be"):
        pq_adc.pq_adc_topk(lut, codes, valid, -1)
    with pytest.raises(ValueError, match="precision"):
        pq_adc.pq_adc_topk(lut, codes, valid, 5, "bf16")
    with pytest.raises(ValueError, match="unsupported device"):
        pq_adc.pq_adc_topk(lut.to("meta"), codes.to("meta"),
                           valid.to("meta"), 5)
    s, i = pq_adc.pq_adc_topk(lut, codes, valid, 0)
    assert s.shape == i.shape == (2, 0)
    s, i = pq_adc.pq_adc_topk(lut, codes[:0], valid[:0], 5)
    assert s.shape == i.shape == (2, 0)


def _gallery():
    """A CPU PQGallery of 64 rows (rows 3 and 10 equal) in 80 slots."""
    rng = np.random.default_rng(5)
    codec = tpq.PQCodec(torch.from_numpy(
        rng.normal(size=(8, 16, 4)).astype(np.float32)))
    g = tpq.PQGallery(codec, capacity=80, keep_exact=True, device="cpu")
    emb = rng.normal(size=(64, 32)).astype(np.float32)
    emb[10] = emb[3]
    g.add(np.arange(64) + 100, emb)
    return g, emb


@pytest.mark.parametrize("k", (pq_adc.KMAX, pq_adc.KMAX + 1))
def test_k_above_kmax_routes_to_the_present_path(k, monkeypatch):
    """The search scores a shard once with ``adc_candidates`` and merges
    once, at k up to KMAX and above; on the CPU both are the chain (the
    scores of every row, then the stable sort), and answer as it. The
    card test below holds the dispatch by k."""
    g, emb = _gallery()
    calls = []
    real = tpq.adc_candidates

    def counted(*a, **kw):
        out = real(*a, **kw)
        calls.append((out.rows is None, out.s.shape))
        return out

    monkeypatch.setattr(tpq, "adc_candidates", counted)
    s, i = tpq.sharded_pq_top_k(emb[:4], g.codec, g._shards, k)
    assert calls == [(True, (4, 80))]
    lut = g.codec.lut(emb[:4])
    assert_as_both_chains((s, i), lut, g._shards.rows[0],
                          g._shards.valid[0], k, "hilo")
    _, wi = g.search(emb[4:8], k=5, rerank=k)
    assert wi[:, 0].tolist() == [104, 105, 106, 107]


# ------------------------------------------------------------ on the card


@pytest.mark.card
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("precision", pq_adc.PRECISIONS)
@pytest.mark.parametrize("case", CASES)
def test_fused_topk_bit_equal_on_the_card(card, case, precision, k):
    """The fused kernel and its merge against both chains on the card, at
    every Q, over galleries from one row (fewer than k) to 2M rows (more
    rows than the grid's first pass); rows offset as a shard's."""
    before = pq_adc.topk_launches
    n = 0
    for q in QS:
        for g in (1, 37, 4097, 200_003) + ((2_000_000,) if q == 64 else ()):
            lut, codes, valid = (x.to(card) for x in workload(
                case, q, g, seed=q * 1000 + g, m=64, k=256))
            got = pq_adc.pq_adc_topk(lut, codes, valid, k, precision, 11)
            torch.cuda.synchronize()
            assert_as_both_chains(got, lut, codes, valid, k, precision, 11)
            n += 1
    assert pq_adc.topk_launches == before + n


@pytest.mark.card
def test_fused_topk_argument_checks_on_the_card(card):
    lut, codes, valid = (x.to(card) for x in workload("random", 2, 50, 1))
    with pytest.raises(ValueError, match="valid"):
        pq_adc.pq_adc_topk(lut, codes, valid.to(torch.uint8), 5)
    with pytest.raises(ValueError, match="valid"):
        pq_adc.pq_adc_topk(lut, codes, valid[:-1], 5)
    with pytest.raises(ValueError, match="valid"):
        pq_adc.pq_adc_topk(lut, codes, valid.cpu(), 5)
    with pytest.raises(ValueError, match="codes"):
        pq_adc.pq_adc_topk(lut, codes[:, :8].contiguous(), valid, 5)
    with pytest.raises(ValueError, match="contiguous"):
        pq_adc.pq_adc_topk(lut.transpose(1, 2).contiguous().transpose(
            1, 2), codes, valid, 5)
    s, i = pq_adc.pq_adc_topk(lut[:0], codes, valid, 5)
    assert s.shape == (0, 5) and i.device.type == "cuda"


@pytest.mark.card
@pytest.mark.parametrize("k", (pq_adc.KMAX, pq_adc.KMAX + 1))
def test_k_above_kmax_routes_to_the_present_path_on_the_card(card, k):
    """On the card k up to KMAX launches the fused kernel (lists of k, no
    (Q, G) scores); a larger k launches K2 alone and sorts its scores, as
    before. Both answer as the two chains."""
    lut, codes, valid = (x.to(card) for x in workload(
        "invalid", 5, 4097, seed=4, m=64, k=256))
    n0 = (pq_adc.launches, pq_adc.topk_launches)
    c = pq_adc.adc_candidates(lut, codes, valid, k, "hilo")
    fused = k <= pq_adc.KMAX
    assert (pq_adc.launches - n0[0], pq_adc.topk_launches - n0[1]) == (
        int(not fused), int(fused))
    assert (c.rows is not None) == fused
    assert c.s.shape[-1] == (k if fused else 4097)
    got = pq_adc.merge_candidates(c, 3)
    assert_as_both_chains(got, lut, codes, valid, k, "hilo", 3)


@pytest.mark.card
def test_fused_topk_on_a_sharded_gallery_on_the_card(card):
    """Four shards of one card: the fused top-k once a shard, with the
    shard's row offset, answering as the unsharded gallery and as the
    chain over the joined codes."""
    from scrfd_arcface_facerecognition_tpu_torch.parallel import (
        device_slots, make_mesh)

    mesh = make_mesh((4,), ("model",), devices=device_slots("cuda:0", 4))
    rng = np.random.default_rng(9)
    cent = rng.normal(size=(64, 256, 8)).astype(np.float32)
    rows = rng.normal(size=(3000, 512)).astype(np.float32)
    rows[[1500, 2900]] = rows[7]
    galleries = []
    for m in (mesh, None):
        g = tpq.PQGallery(tpq.PQCodec.from_centroids(cent, card),
                          capacity=4000, mesh=m, device=card)
        g.add(np.arange(3000), rows)
        g.delete(11)
        galleries.append(g)
    q = rows[[7, 11, 40, 2999]]
    for precision in pq_adc.PRECISIONS:
        for k in KS:
            n0 = pq_adc.topk_launches
            s, i = galleries[0].search(q, k=k, precision=precision)
            assert pq_adc.topk_launches == n0 + 4
            fs, fi = galleries[1].search(q, k=k, precision=precision)
            np.testing.assert_array_equal(i, fi)
            np.testing.assert_array_equal(s.view(np.int32),
                                          fs.view(np.int32))
            lut = galleries[1].codec.lut(q)
            got = tpq.sharded_pq_top_k(q, galleries[0].codec,
                                       galleries[0]._shards, k, precision)
            assert_as_both_chains(got, lut, galleries[1]._codes,
                                  galleries[1]._shards.valid[0], k,
                                  precision)
    assert i[0, :3].tolist() == [7, 1500, 2900]


@pytest.mark.card
def test_fused_topk_past_2_31_scores_on_the_card(card):
    """Q 256 over 10M rows (2.56e9 scores, past 2^31) in one fused call,
    against both chains taken 32 queries at a time."""
    gen = torch.Generator(device=card).manual_seed(3)
    g, m = 10_000_000, 64
    proto = torch.randint(0, 256, (1000, m), generator=gen,
                          dtype=torch.uint8, device=card)
    codes = proto[torch.randint(0, 1000, (g,), generator=gen, device=card)]
    fresh = torch.rand((g, m), generator=gen, device=card) < 1 / 32
    codes = torch.where(fresh, torch.randint(
        0, 256, (g, m), generator=gen, dtype=torch.uint8, device=card),
        codes).contiguous()
    del fresh
    valid = torch.rand((g,), generator=gen, device=card) < 0.9
    lut = torch.randn((256, m, 256), generator=gen, device=card)
    for precision in pq_adc.PRECISIONS:
        s, i = pq_adc.pq_adc_topk(lut, codes, valid, 5, precision)
        for q0 in range(0, 256, 32):
            assert_as_both_chains((s[q0:q0 + 32], i[q0:q0 + 32]),
                                  lut[q0:q0 + 32].contiguous(), codes, valid,
                                  5, precision)
