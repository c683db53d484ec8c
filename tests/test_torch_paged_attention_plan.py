"""The host side of the paged-attention kernels' shared design
(``paddle_tpu_torch/ops/cuda/paged_attention_plan.py``), checked on the
CPU with no JAX:

- the row-tile rule, the tile loop and the KV split the kernels apply on
  the device (mirrored by ``row_tiles`` / ``split_tiles``, sized by
  ``grid_plan``) work every (row, query head, visible position) of a
  ragged batch exactly once, on the serving engine's own row layout, a
  sequence in two separate runs, and rows = 1, 8, 96 and 128, at 132 SMs
  and at 8;
- a float32 model of the split-then-merge decomposition (per-split
  (m, l, acc) partials, empty splits, a merge in split order) equals
  ``ragged_paged_attention_reference`` within 1e-6 (of the largest |V|)
  on ``test_torch_paged_attention.py``'s geometries, int8 pools included;
- both CUDA wrappers raise on CPU tensors and on an unsupported
  head_dim, before any library is loaded.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.ops.cuda import paged_attention_plan as plan
from paddle_tpu_torch.ops.cuda.paged_attention_decode import \
    paged_attention_decode_cuda
from paddle_tpu_torch.ops.cuda.ragged_paged_attention import \
    ragged_paged_attention_cuda

# the 8B serving geometry the coverage cases use
NH, KVH, D, BS, MP = 32, 8, 128, 64, 32


def _engine_rows(rows, rng, max_b=8):
    """A ragged chunk laid out as ServingEngine._dispatch_ragged_chunk
    lays one ministep: decode columns (one row per running slot), then
    prefill runs of whole requests that cross 16-row boundaries, then
    scratch padding rows (row_seq = max_b, ctx 0)."""
    n_dec = min(rows, int(rng.randint(0, max_b + 1)))
    seq = list(rng.permutation(max_b)[:n_dec])
    ctx = [int(c) for c in rng.randint(1, MP * BS + 1, n_dec)]
    free = [s for s in range(max_b) if s not in seq]
    left = rows - n_dec - int(rng.randint(0, max(1, rows // 8)))
    while left > 0 and free:
        take = min(left, int(rng.randint(5, 40)))
        s = free.pop(int(rng.randint(len(free))))
        off = int(rng.randint(0, MP * BS - take))
        seq += [s] * take
        ctx += list(range(off + 1, off + take + 1))
        left -= take
    seq += [max_b] * (rows - len(seq))
    ctx += [0] * (rows - len(ctx))
    return np.asarray(seq), np.asarray(ctx)


def _layout(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    if name.startswith("engine_"):
        return _engine_rows(int(name.split("_")[1]), rng)
    if name == "two_runs":  # sequence 3 in two separate runs
        seq = [0, 1] + [3] * 5 + [4] * 3 + [3] * 22 + [8] * 2
        ctx = [700, 64] + list(range(100, 105)) + [1, 2, 3] \
            + list(range(105, 127)) + [0, 0]
        return np.asarray(seq), np.asarray(ctx)
    if name == "decode_8":
        return np.arange(8), rng.randint(1, MP * BS + 1, 8)
    raise ValueError(name)


LAYOUTS = ["engine_1", "engine_8", "engine_96", "engine_128", "two_runs",
           "decode_8"]


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_row_tiles_and_splits_cover_each_position_once(layout, sms):
    row_seq, row_ctx = _layout(layout)
    rows = len(row_seq)
    group = NH // KVH
    decode = layout == "decode_8"
    R = plan.tile_rows(group, decode)
    splits, deep, blocks = plan.grid_plan(rows, KVH, MP, BS, sms)
    assert 1 <= splits <= plan.MAX_SPLITS and 1 <= blocks <= rows
    # the grid never asks for more blocks than are resident (one an SM
    # with the deep ring, two otherwise), unless a single row and split
    # already pass them
    resident = sms if deep else 2 * sms
    assert deep == (rows * KVH <= sms)
    assert blocks * KVH * splits <= max(resident, KVH * splits)
    tiles = plan.row_tiles(row_seq, R) if not decode \
        else [(r, 1) for r in range(rows)]
    # block b works tiles b, b + blocks, ...: each tile once
    owner = [k % blocks for k in range(len(tiles))]
    assert len(owner) == len(tiles) and max(owner) < blocks
    cap = MP * BS
    ctx = np.clip(row_ctx, 0, cap)
    cover = np.zeros((rows, NH, cap), np.int32)
    seen = np.zeros(rows, np.int32)
    for r0, n in tiles:
        assert 1 <= n <= R and (r0 + n - 1) // R == r0 // R
        assert r0 // 32 == (r0 + n - 1) // 32  # inside one 32-row ballot
        assert (row_seq[r0:r0 + n] == row_seq[r0]).all()
        assert r0 % R == 0 or row_seq[r0 - 1] != row_seq[r0]
        seen[r0:r0 + n] += 1
        n_pos = int(ctx[r0:r0 + n].max())
        ranges = plan.split_tiles(n_pos, n * group, D, False, splits)
        assert len(ranges) == splits
        nt = -(-n_pos // plan.TILE_POS)
        for b, e in ranges:
            assert e - b == 0 or e - b >= min(plan.MIN_SPLIT_TILES, nt)
        if n_pos == 0:
            assert all(b == e for b, e in ranges)
        for h in range(KVH):
            for m in range(n * group):
                r, head = r0 + m // group, h * group + m % group
                for b, e in ranges:
                    lo, hi = b * plan.TILE_POS, min(e * plan.TILE_POS,
                                                    ctx[r])
                    if hi > lo:
                        cover[r, head, lo:hi] += 1
    assert (seen == 1).all()
    for r in range(rows):
        assert (cover[r, :, :ctx[r]] == 1).all(), (layout, r)
        assert (cover[r, :, ctx[r]:] == 0).all(), (layout, r)


def test_plan_at_the_8b_serving_shapes():
    """The grid the 8B cases get on an H100 (132 SMs): a W 8 decode
    ministep (either entry) one block a row with the deep ring and up to
    2 splits, b 4 up to 4, a 136-row prefill rung 33 blocks a kv-head with
    the regular ring and no split; row tiles of 8 rows at group 4; bf16
    at d 64 / 128 with 16-multiple pages takes the tensor cores, nothing
    else."""
    assert plan.grid_plan(8, 8, 128, 64, 132) == (2, True, 8)
    assert plan.grid_plan(4, 8, 128, 64, 132) == (4, True, 4)
    assert plan.grid_plan(136, 8, 128, 64, 132) == (1, False, 33)
    assert [plan.tile_rows(g) for g in (1, 2, 3, 4, 5, 8)] == \
        [32, 16, 8, 8, 4, 4]
    assert plan.tile_rows(4, decode=True) == 1
    # ctx 512 at W 8: two splits of 4 stages; a 2100-token row: two of 16
    # and 17; fewer than 8 stages: no split
    assert plan.split_tiles(512, 4, 128, False, 2) == [(0, 4), (4, 8)]
    assert plan.split_tiles(2100, 4, 128, False, 2) == [(0, 16), (16, 33)]
    assert plan.split_tiles(40, 4, 128, False, 2) == [(0, 1), (0, 0)]
    assert plan.split_tiles(300, 4, 128, False, 2) == [(0, 5), (0, 0)]
    tc = plan.tensor_core_route
    assert tc(torch.bfloat16, 128, 64) and tc(torch.bfloat16, 64, 16)
    assert tc(torch.bfloat16, 128, 256)
    assert not tc(torch.float32, 128, 64)
    assert not tc(torch.bfloat16, 256, 64)
    assert not tc(torch.bfloat16, 32, 64)
    assert not tc(torch.bfloat16, 128, 8)
    assert not tc(torch.bfloat16, 128, 48)


# the geometries of tests/test_torch_paged_attention.py (GEOMS, _rand_case)
GEOMS = [
    dict(kvh=2, group=4, d=64, bs=16, nblocks=32, mp=4, n_seqs=3,
         decode_rows=3, chunk_rows=7),
    dict(kvh=1, group=1, d=64, bs=8, nblocks=24, mp=5, n_seqs=4,
         decode_rows=5, chunk_rows=4),
    dict(kvh=4, group=1, d=64, bs=8, nblocks=40, mp=3, n_seqs=2,
         decode_rows=2, chunk_rows=11),
]


def _rand_case(rng, kvh, group, d, bs, nblocks, mp, n_seqs, decode_rows,
               chunk_rows, quantized=False):
    if quantized:
        kc = (rng.randint(-127, 128, (nblocks, kvh, bs, d)).astype(np.int8),
              rng.uniform(0.001, 0.05, (nblocks, kvh, bs)).astype(np.float32))
        vc = (rng.randint(-127, 128, (nblocks, kvh, bs, d)).astype(np.int8),
              rng.uniform(0.001, 0.05, (nblocks, kvh, bs)).astype(np.float32))
    else:
        kc = rng.randn(nblocks, kvh, bs, d).astype(np.float32)
        vc = rng.randn(nblocks, kvh, bs, d).astype(np.float32)
    tables = rng.choice(nblocks, (n_seqs, mp), replace=False).astype(np.int32)
    row_seq, row_ctx = [], []
    for i in range(decode_rows):
        row_seq.append(i % n_seqs)
        row_ctx.append(int(rng.randint(1, mp * bs + 1)))
    off = int(rng.randint(0, mp * bs - chunk_rows))
    for j in range(chunk_rows):
        row_seq.append(n_seqs - 1)
        row_ctx.append(off + j + 1)
    row_seq += [0, 0]
    row_ctx += [0, 0]
    q = rng.randn(len(row_seq), kvh * group, d).astype(np.float32)
    return (q, kc, vc, tables, np.asarray(row_seq, np.int32),
            np.asarray(row_ctx, np.int32))


def _plane(a):
    if isinstance(a, tuple):
        return torch.from_numpy(a[0]).float() * torch.from_numpy(a[1])[..., None]
    return torch.from_numpy(a)


def _split_merge_model(case, splits, tile_pos):
    """The kernels' decomposition in float32 torch: units of the row-tile
    rule, each cut into its splits' position ranges; a split keeps
    (m, l, acc) of its range with each row masked at its own ctx (an
    empty range or rows that see none of it: m = -1e30, l = 0); the
    partials merge in split order, skipping l = 0, into acc / max(l,
    1e-30)."""
    q, kc, vc, tables, row_seq, row_ctx = case
    k, v = _plane(kc), _plane(vc)               # [nb, kvh, bs, d]
    nb, kvh, bs, d = k.shape
    rows, nh, _ = q.shape
    group, mp = nh // kvh, tables.shape[1]
    cap = mp * bs
    scale = 1.0 / math.sqrt(d)
    R = plan.tile_rows(group)
    out = torch.zeros(rows, nh, d)
    qt = torch.from_numpy(q)
    for r0, n in plan.row_tiles(row_seq, R):
        seq = min(max(int(row_seq[r0]), 0), tables.shape[0] - 1)
        pages = np.clip(tables[seq], 0, nb - 1)
        kk = k[pages].permute(1, 0, 2, 3).reshape(kvh, cap, d)
        vv = v[pages].permute(1, 0, 2, 3).reshape(kvh, cap, d)
        ctx = torch.from_numpy(np.clip(row_ctx[r0:r0 + n], 0, cap))
        n_pos = int(ctx.max())
        ranges = plan.split_tiles(n_pos, n * group, d, isinstance(kc, tuple),
                                  splits, tile_pos)
        qs = qt[r0:r0 + n].reshape(n, kvh, group, d)
        parts = []
        for b, e in ranges:
            # the split's positions, a page (or the part of one inside the
            # split) at a time, each with the reference's online update
            lo, hi = b * tile_pos, min(e * tile_pos, n_pos)
            m = torch.full((n, kvh, group), -1e30)
            l = torch.zeros(n, kvh, group)
            acc = torch.zeros(n, kvh, group, d)
            for c0 in range(lo, max(hi, lo), bs):
                c1 = min(hi, (c0 // bs + 1) * bs)
                pos = torch.arange(c0, c1)
                sc = torch.einsum("nkgd,ksd->nkgs", qs, kk[:, c0:c1]) * scale
                vis = (pos[None, :] < ctx[:, None])[:, None, None, :]
                sc = torch.where(vis, sc, torch.full_like(sc, -1e30))
                m_new = torch.maximum(m, sc.amax(dim=-1))
                prob = torch.where(vis, torch.exp(sc - m_new[..., None]),
                                   torch.zeros_like(sc))
                corr = torch.exp(m - m_new)
                l = l * corr + prob.sum(dim=-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "nkgs,ksd->nkgd", prob, vv[:, c0:c1])
                m = m_new
            parts.append((m, l, acc))
        mstar = torch.stack([m for m, _, _ in parts]).amax(0) if parts \
            else torch.full((n, kvh, group), -1e30)
        l_tot = torch.zeros(n, kvh, group)
        acc = torch.zeros(n, kvh, group, d)
        for m, l, a in parts:
            w = torch.where(l > 0, torch.exp(m - mstar), torch.zeros_like(l))
            l_tot = l_tot + w * l
            acc = acc + w[..., None] * a
        out[r0:r0 + n] = (acc / l_tot.clamp(min=1e-30)[..., None]) \
            .reshape(n, nh, d)
    return out


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("tile_pos", [plan.TILE_POS, 8])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("gi", range(len(GEOMS)))
def test_split_merge_model_matches_reference(gi, quantized, tile_pos, splits):
    """Split counts 1 and 3 at the kernel's 64-position stages and at 8
    (which cuts these contexts into two non-empty splits and an empty
    one)."""
    rng = np.random.RandomState(100 + gi)
    case = _rand_case(rng, quantized=quantized, **GEOMS[gi])
    model = _split_merge_model(case, splits, tile_pos)

    def conv(a):
        return tuple(torch.from_numpy(x) for x in a) \
            if isinstance(a, tuple) else torch.from_numpy(a)

    ref = tpa.ragged_paged_attention_reference(*[conv(a) for a in case])
    # outputs are weighted means of V rows: 1e-6 of the largest |V| (a few
    # float32 ulps of what is averaged; int8 pools reach |V| ~ 6, where the
    # batched einsums of the two versions round differently)
    vmax = float(_plane(case[2]).abs().max())
    np.testing.assert_allclose(model.numpy(), ref.numpy(), atol=1e-6 * vmax,
                               rtol=1e-6)
    assert (model[-2:] == 0).all()


@pytest.mark.parametrize("entry", ["ragged", "decode"])
def test_cuda_wrappers_raise_on_cpu_tensors_and_bad_head_dim(entry):
    """The wrappers take CUDA tensors only (no fallback to the plain
    version) and raise on a head_dim no kernel takes, before any library
    is loaded."""
    g = torch.Generator().manual_seed(0)

    def call(d):
        q = torch.randn(2, 8, d, generator=g).to(torch.bfloat16)
        pool = torch.randn(4, 2, 16, d, generator=g).to(torch.bfloat16)
        tables = torch.zeros(2, 2, dtype=torch.int32)
        idx = torch.arange(2, dtype=torch.int32)
        if entry == "ragged":
            return ragged_paged_attention_cuda(q, pool, pool, tables, idx,
                                               idx + 1)
        return paged_attention_decode_cuda(q, pool, pool, tables, idx + 1)

    with pytest.raises(ValueError, match="CUDA device"):
        call(128)
    with pytest.raises(ValueError, match="head_dim 96"):
        call(96)
