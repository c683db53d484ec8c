"""The work lists of the Hopper flash-attention kernels
(``paddle_tpu_torch/ops/cuda/flash_attention.py::flash_schedule``).

The forward, dq and dk/dv kernels visit only the tiles their list names
and skip the per-element mask on the tiles it marks mask-free, so the
list decides which (query, key) pairs reach the sums. For every
sq, sk in {1, 63, 64, 65, 127, 128, 129, 300, 1000, 2048}, causal or
not, segmented or not, and each kernel's tiles, the list is checked
against the visible mask built as JAX's ``_fwd_kernel`` builds it
(row iota + (sk - sq) >= column iota, and equal segment ids), in numpy:

- the tile ranges cover every visible pair exactly once, and every pair
  outside them is invisible;
- a tile marked mask-free holds only visible pairs, counting the
  padding of a ragged streamed tile as invisible;
- the rows are ordered longest first, every (batch, head, tile) appears
  once, and the cache returns the same object.

Also: the CUDA wrappers raise on CPU tensors instead of falling back.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.ops.cuda import flash_attention as cfa  # noqa: E402

SIZES = (1, 63, 64, 65, 127, 128, 129, 300, 1000, 2048)


def _visible(sq, sk, causal, segmented):
    """[sq, sk] bool: query row r sees key c (JAX's _fwd_kernel mask)."""
    vis = np.ones((sq, sk), dtype=bool)
    if causal:
        vis = np.arange(sq)[:, None] + (sk - sq) >= np.arange(sk)[None, :]
    if segmented:
        # packed documents of random lengths with a padded tail, as the
        # packed cases of chip_smoke.py make them
        rng = np.random.RandomState(sq * 7919 + sk)
        n = max(sq, sk)
        ids = np.cumsum(rng.rand(n) < 0.02).astype(np.int32)
        q_ids, k_ids = ids[:sq].copy(), ids[:sk].copy()
        q_ids[sq - sq // 8:] = -1
        k_ids[sk - sk // 8:] = -2
        vis &= q_ids[:, None] == k_ids[None, :]
    return vis


def _check(kind, sq, sk, causal, segmented):
    b, h, hk = 2, 4, 2
    bm, bn = cfa.TILES[kind]
    rows = cfa.flash_schedule(kind, b, sq, sk, h, hk, causal, segmented)
    assert rows.dtype == np.int32 and rows.shape[1] == 8
    assert cfa.flash_schedule(kind, b, sq, sk, h, hk, causal,
                              segmented) is rows
    vis = _visible(sq, sk, causal, segmented)
    if kind == "dkv":  # own key rows, streamed query tiles
        vis, own, stream, heads = vis.T, sk, sq, hk
    else:
        own, stream, heads = sq, sk, h
    n_stream = -(-stream // bn)
    # padded: streamed positions past the end are invisible
    padded = np.zeros((own, n_stream * bn), dtype=bool)
    padded[:, :stream] = vis

    seen = set()
    lengths = rows[:, 4] - rows[:, 3]
    assert (np.diff(lengths) <= 0).all(), "rows not longest first"
    cover = {}
    for bi, hd, t, lo, hi, flo, fhi, pad in rows.tolist():
        assert pad == 0 and 0 <= bi < b and 0 <= hd < heads
        assert (bi, hd, t) not in seen
        seen.add((bi, hd, t))
        assert 0 <= lo <= hi <= n_stream
        assert lo <= flo <= fhi <= hi
        if segmented:
            assert flo == fhi, "a segmented tile marked mask-free"
        r0, r1 = t * bm, min(t * bm + bm, own)
        for kt in range(flo, fhi):
            assert padded[r0:r1, kt * bn:kt * bn + bn].all(), \
                f"tile {kt} of row tile {t} marked mask-free"
        cover.setdefault(t, []).append((lo, hi))
    assert len(seen) == b * heads * -(-own // bm)
    count = np.zeros((own, n_stream * bn), dtype=np.int32)
    for t, ranges in cover.items():
        # the ranges depend on the tile only, never on batch or head
        assert len(set(ranges)) == 1
        lo, hi = ranges[0]
        count[t * bm:t * bm + bm, lo * bn:hi * bn] += 1
    count = count[:, :stream]
    assert (count[vis] == 1).all(), "a visible pair outside the ranges"
    assert (count <= 1).all()
    return rows


@pytest.mark.parametrize("segmented", [False, True],
                         ids=["plain", "segmented"])
@pytest.mark.parametrize("causal", [False, True],
                         ids=["full", "causal"])
@pytest.mark.parametrize("sk", SIZES)
@pytest.mark.parametrize("sq", SIZES)
def test_schedule_covers_visible_pairs(sq, sk, causal, segmented):
    for kind in cfa.TILES:
        _check(kind, sq, sk, causal, segmented)


def test_schedule_skips_and_balances_causal_work():
    """At llama_mid's shape the causal lists visit about half the tiles,
    mask only the diagonal and start with the heaviest rows."""
    b, s, h, hk = 4, 2048, 16, 8
    fwd = cfa.flash_schedule("fwd", b, s, s, h, hk, True, False)
    n = s // 128
    assert fwd.shape[0] == b * h * n
    assert (fwd[:b * h, 4] == n).all() and (fwd[-b * h:, 4] == 1).all()
    assert ((fwd[:, 4] - fwd[:, 6]) == 1).all()  # one diagonal tile each
    assert int((fwd[:, 4] - fwd[:, 3]).sum()) == b * h * n * (n + 1) // 2
    dkv = cfa.flash_schedule("dkv", b, s, s, h, hk, True, False)
    assert dkv.shape[0] == b * hk * n
    # a 128-key tile meets two 64-row query tiles on the diagonal
    masked = (dkv[:, 4] - dkv[:, 3]) - (dkv[:, 6] - dkv[:, 5])
    assert (masked == 2).all()
    assert ((dkv[:, 4] - dkv[:, 3])[:-1] >= (dkv[:, 4] - dkv[:, 3])[1:]).all()


@pytest.mark.parametrize("call", ["fwd", "dq", "dkv", "bwd"])
def test_cuda_wrappers_raise_on_cpu_tensors(call):
    """The kernels' wrappers take CUDA tensors only: a CPU tensor raises
    before any library is loaded, with no fallback to the plain
    version."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 64, 2, 64, generator=g).to(torch.bfloat16)
    k = torch.randn(1, 64, 1, 64, generator=g).to(torch.bfloat16)
    v = torch.randn(1, 64, 1, 64, generator=g).to(torch.bfloat16)
    lse = torch.zeros(1, 2, 64)
    fns = {
        "fwd": lambda: cfa.flash_fwd_cuda(q, k, v, True, 0.125),
        "dq": lambda: cfa.flash_bwd_dq_cuda(q, k, v, q, lse, lse, True,
                                            0.125),
        "dkv": lambda: cfa.flash_bwd_dkv_cuda(q, k, v, q, lse, lse, True,
                                              0.125),
        "bwd": lambda: cfa.flash_bwd_cuda(q, k, v, q, lse, q, True, 0.125),
    }
    with pytest.raises(ValueError, match="CUDA device"):
        fns[call]()


# -- dk/dv lists cut into pieces (fewer key tiles than SMs) -----------------

SMS = 132


def _check_split(sq, sk, causal, segmented, b=2, h=4, hk=2):
    """A "dkv" list built for SMS SMs against the unsplit list: the
    pieces of each row are contiguous, numbered 0, 1, ... in order, and
    together cover the unsplit row's range exactly once (so every
    visible pair of the tile is visited once); every piece but a row's
    only one holds at least 2 streamed tiles; the free range of each
    piece is the unsplit free range clipped to it; a list of at least
    SMS rows is the unsplit one, byte for byte."""
    whole = cfa.flash_schedule("dkv", b, sq, sk, h, hk, causal, segmented)
    split = cfa.flash_schedule("dkv", b, sq, sk, h, hk, causal, segmented,
                               SMS)
    assert split.dtype == np.int32 and split.shape[1] == 8
    if whole.shape[0] >= SMS:
        np.testing.assert_array_equal(split, whole)
        return split
    lengths = split[:, 4] - split[:, 3]
    assert (np.diff(lengths) <= 0).all(), "rows not longest first"
    pieces = {}
    for row in split.tolist():
        pieces.setdefault(tuple(row[:3]), []).append(row)
    assert len(pieces) == whole.shape[0]
    for bi, hd, t, lo, hi, flo, fhi, pad in whole.tolist():
        got = sorted(pieces[(bi, hd, t)], key=lambda r: r[7])
        assert [r[7] for r in got] == list(range(len(got)))
        assert got[0][3] == lo and got[-1][4] == hi
        for a, c in zip(got, got[1:]):
            assert a[4] == c[3], "pieces not contiguous"
        for r in got:
            assert r[3] <= r[4]
            if len(got) > 1:
                assert r[4] - r[3] >= 2, "a piece under 2 streamed tiles"
            pflo, pfhi = max(flo, r[3]), min(fhi, r[4])
            if pfhi <= pflo:
                pflo = pfhi = r[3]
            assert (r[5], r[6]) == (pflo, pfhi)
    # the pieces of a tile are the same for every batch and head
    per_tile = {}
    for (bi, hd, t), rows in pieces.items():
        shape = sorted((r[3], r[4], r[7]) for r in rows)
        assert per_tile.setdefault(t, shape) == shape
    n = cfa.dkv_pieces(split, sk)
    assert n.tolist() == [len(per_tile[t]) for t in sorted(per_tile)]
    # as many rows as SMs, unless the tiles are too short to give them
    caps = [max(1, (hi - lo) // 2) for hi, lo in
            zip(whole[:, 4].tolist(), whole[:, 3].tolist())]
    assert split.shape[0] >= min(SMS, sum(caps))
    return split


@pytest.mark.parametrize("segmented", [False, True],
                         ids=["plain", "segmented"])
@pytest.mark.parametrize("causal", [False, True],
                         ids=["full", "causal"])
@pytest.mark.parametrize("sk", SIZES)
@pytest.mark.parametrize("sq", SIZES)
def test_split_dkv_lists_cover_each_pair_once(sq, sk, causal, segmented):
    """Every split list at sq, sk in SIZES still passes _check's cover
    of the visible mask once its pieces are merged back per tile."""
    split = _check_split(sq, sk, causal, segmented)
    assert (split[:, 7] >= 0).all()


# the sep-4 ring's three shard shapes at train-mid8k (llama_mid, b 1,
# h 16, kv 8): the pieces each key tile of 128 rows is cut into, and the
# rows of the list
@pytest.mark.parametrize("name,sq,sk,causal,pieces,rows", [
    ("diagonal", 1024, 1024, True, [3, 3, 3, 3, 3, 3, 2, 1], 168),
    ("earlier", 2048, 1024, False, [3] * 8, 192),
    ("later", 1024, 2048, False, [2] * 16, 256),
])
def test_ring_shard_dkv_pieces(name, sq, sk, causal, pieces, rows):
    split = _check_split(sq, sk, causal, False, b=1, h=16, hk=8)
    assert cfa.dkv_pieces(split, sk).tolist() == pieces
    assert split.shape[0] == rows


def test_long_lists_are_never_split():
    """llama_mid's dk/dv list (512 rows) and every forward and dq list
    are the same with the SM count as without it."""
    for kind in ("fwd", "dq", "dkv"):
        whole = cfa.flash_schedule(kind, 4, 2048, 2048, 16, 8, True, False)
        split = cfa.flash_schedule(kind, 4, 2048, 2048, 16, 8, True, False,
                                   SMS)
        np.testing.assert_array_equal(split, whole)
        assert (split[:, 7] == 0).all()
    for kind in ("fwd", "dq"):
        small = cfa.flash_schedule(kind, 1, 1024, 1024, 16, 8, True, False)
        np.testing.assert_array_equal(
            cfa.flash_schedule(kind, 1, 1024, 1024, 16, 8, True, False, SMS),
            small)


# DiT-XL/2's attention (b 32 x 256 patches, 16 / 16 heads, not causal):
# the work lists of its forward, dq and dk/dv kernels at head_dim 72
@pytest.mark.parametrize("kind", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("sms", [None, SMS], ids=["whole", "sms"])
def test_dit_xl2_lists(kind, sms):
    """1024 rows (32 x 16 heads x 2 own tiles of 128 rows), each over
    all 256 streamed rows (2 tiles of 128 for the forward, 4 of 64 for
    dq and dk/dv) and free of the mask throughout; no pieces (the list
    has more rows than SMs), so the workspace is not used."""
    rows = cfa.flash_schedule(kind, 32, 256, 256, 16, 16, False, False, sms)
    assert rows.shape == (1024, 8)
    assert len({tuple(r) for r in rows[:, :3].tolist()}) == 1024
    assert sorted(set(rows[:, 2].tolist())) == [0, 1]
    assert cfa.TILES[kind][1] == (128 if kind == "fwd" else 64)
    assert (rows[:, 3] == 0).all()
    assert (rows[:, 4] == 256 // cfa.TILES[kind][1]).all()
    assert (rows[:, 5] == rows[:, 3]).all() and (rows[:, 6] == rows[:, 4]).all()
    assert (rows[:, 7] == 0).all()
    np.testing.assert_array_equal(
        rows, cfa.flash_schedule(kind, 32, 256, 256, 16, 16, False, False))
    if kind == "dkv":
        assert cfa.dkv_pieces(rows, 256).tolist() == [1, 1]

