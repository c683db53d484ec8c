"""Host side of the paged-attention kernels' shared design
(``csrc/paged_attention.cuh``): which route a call takes, the grid it
launches, and, as a plain-Python mirror of what the device decides for
itself, the row tiles and each KV split's share of positions.

``ragged_paged_attention_cuda`` and ``paged_attention_decode_cuda`` call
``tensor_core_route`` and ``grid_plan`` and hand the plan (KV splits a
unit may take, whether the ring runs deep, grid blocks a kv-head) to the
C entry, which takes it or refuses it (-1), with a float32 workspace and
``counters`` when it splits. ``row_tiles`` and ``split_tiles`` are not called on a
launch: the device applies the same rules to its own ``row_seq`` /
``row_ctx`` with no host sync, and the CPU tests check through these
mirrors that every visible (row, head, position) is worked exactly once.
"""
from __future__ import annotations

import torch

__all__ = ["TILE_POS", "MAX_M", "MAX_SPLITS", "MIN_SPLIT_TILES",
           "tensor_core_route", "tile_rows", "row_tiles", "grid_plan",
           "split_tiles", "counters"]

TILE_POS = 64        # pool positions a stage of the kernel holds
MAX_M = 32           # query vectors (tile rows x group) of a unit
MAX_SPLITS = 16      # KV splits of one unit
MIN_SPLIT_TILES = 4  # stages each split keeps, at least


def tensor_core_route(dtype, head_dim: int, block_size: int) -> bool:
    """True when a call runs the tensor-core kernels: bfloat16 q at
    head_dim 64 or 128, with pages that are whole 16-position chunks and
    either divide the 64-position stage or are a multiple of it. Every
    other call the C entry sends to the CUDA-core kernel."""
    return (dtype == torch.bfloat16 and head_dim in (64, 128)
            and block_size % 16 == 0
            and (block_size % TILE_POS == 0 or TILE_POS % block_size == 0))


def tile_rows(group: int, decode: bool = False) -> int:
    """R, the most rows of one row tile: for the ragged entry the largest
    power of two whose rows hold at most MAX_M = 32 query vectors (the
    rows of a tile's products, two m-tiles), so a tile never spans one
    32-row ballot of the kernel's tile scan; 1 for the decode entry."""
    if decode:
        return 1
    r = MAX_M
    while r > 1 and r * group > MAX_M:
        r //= 2
    return r


def row_tiles(row_seq, rows_per_tile: int):
    """[(first row, rows)] of the row tiles over ``row_seq`` (a sequence
    of ints): a tile starts at every multiple of ``rows_per_tile`` and
    wherever a row's sequence differs from the row before, and runs over
    the following rows of the same sequence up to the next multiple."""
    rs = [int(x) for x in row_seq]
    R = rows_per_tile
    tiles = []
    for r in range(len(rs)):
        if r % R != 0 and rs[r - 1] == rs[r]:
            continue
        lim = min((r // R + 1) * R, len(rs)) - r
        k = 1
        while k < lim and rs[r + k] == rs[r]:
            k += 1
        tiles.append((r, k))
    return tiles


def grid_plan(rows: int, kv_heads: int, max_pages: int, block_size: int,
              sms: int):
    """(splits, deep, blocks) of a tensor-core launch, from host-known
    values only. Its units (row tile, kv-head) number at most rows x
    kv_heads (one a row: a decode batch; a prefill chunk's rows share
    units). When they fit one block an SM the ring runs deep (about 192
    KB of stages in flight a block) and a unit may split its positions
    over up to sms // units blocks; otherwise the ring keeps two blocks
    an SM and a unit splits only while the grid stays within them. Splits
    are at most MAX_SPLITS, and no more than the longest visible range
    (max_pages * block_size positions) holds at MIN_SPLIT_TILES stages
    each; the device takes fewer for a shorter unit (split_tiles). The
    grid is (blocks, kv_heads, splits): block b works tiles b, b +
    blocks, ... of the launch, and blocks stops where the resident
    blocks (one or two an SM) are filled, so no block waits for a slot
    behind another that has nothing to do."""
    units = max(1, rows * kv_heads)
    stages = -(-max_pages * block_size // TILE_POS)
    most = max(1, min(MAX_SPLITS, -(-stages // MIN_SPLIT_TILES)))
    deep = units <= sms
    resident = sms if deep else 2 * sms
    splits = max(1, min(most, resident // units))
    blocks = max(1, min(rows, -(-resident // (kv_heads * splits))))
    return splits, deep, blocks


def split_tiles(n_pos: int, m: int, head_dim: int, quantized: bool,
                splits: int, tile_pos: int = TILE_POS):
    """[(first stage, end stage)] of each split s < ``splits`` of a unit
    whose rows see at most ``n_pos`` positions and that holds ``m``
    query vectors: the unit's stages cut into min(splits, stages)
    contiguous shares of at least MIN_SPLIT_TILES stages (one share when
    there are fewer), fewer where a
    share's merge traffic (float32 (m, l, acc) of m vectors, written and
    read) would pass the K/V bytes it walks; the splits past them get
    nothing (0, 0). ``tile_pos`` other than the kernel's 64 only lets a
    test split tiny contexts."""
    nt = -(-n_pos // tile_pos)
    eff = min(splits, nt, max(1, nt // MIN_SPLIT_TILES))
    if splits > 1:
        row_bytes = head_dim * (1 if quantized else 2)
        kv = n_pos * (2 * row_bytes + (8 if quantized else 0))
        merge = m * (head_dim + 2) * 8
        eff = min(eff, max(1, kv // merge))
    return [(s * nt // eff, (s + 1) * nt // eff) if s < eff else (0, 0)
            for s in range(splits)]


_counters: dict = {}
# buffers outgrown by a larger launch: a captured CUDA graph may still
# point at one, so none is ever freed
_retired: list = []


def counters(device, n: int):
    """int32 zeros of at least n entries on a CUDA device, kept across
    calls: the arrivals of each unit's workers, which the last of them
    sets back to zero. One buffer a device serves every launch of both
    kernels on its stream."""
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf
