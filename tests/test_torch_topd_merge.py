"""The warp top-D rules of the port's kernels, modelled in numpy.

``csrc/cliques.cu`` builds each anchor's top-d list with one warp:
lane l offers candidates l, l + 32, l + 64, ... in increasing index
order to its own list of d slots (insertion only on a strictly greater
value, the walk of ``topd.cuh: lanelist_insert``), then the warp takes
d rounds of an arg-max over the 32 list heads on the key (value desc,
index asc), computed by a butterfly of five xor exchanges, and pops
the winner's head (``topd.cuh: warp_merge_topd``).

``csrc/neighbors.cu`` (kernel 1) stages each tile of candidates
compacted to the unmasked ones and scans them 32 at a time.  For
d <= 32 it appends the positive IoUs above its current d-th value to a
buffer of 64 that keeps its top d whenever it holds more than 32,
keeps the first d zero-IoU candidates in index order apart, and at the
end places each buffered entry by its rank on (value desc, index asc),
the zeros after the positives.  Longer lists are one sorted list per
warp, filled in index order.

The models below do exactly that, on every anchor at once, and must
give the lists of ``lax.top_k`` and of the Pallas neighbour kernel:
values and indices exact, on inputs full of ties (zero IoUs, duplicated
boxes, masked rows) with candidate counts that are not multiples of 32.
They pin the rules before the kernels run on a card;
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernels
themselves to the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repic_tpu.ops.iou_pallas import pallas_topk_neighbors
from repic_tpu_torch.ops import iou_pallas as tk
from repic_tpu_torch.ops.cliques import dense_neighbors
from repic_tpu_torch.ops.iou import pair_iou
from torch_port_common import n, t

LANES = 32
PAD_ID = np.iinfo(np.int32).max
BOX = 180.0
#: candidates staged per tile and buffered positives per warp in
#: csrc/neighbors.cu (kTile, kBuf)
KERNEL_TILE = 1024
KBUF = 64


def _before(va, ia, vb, ib):
    """(va, ia) ahead of (vb, ib): value desc, then index asc."""
    return (va > vb) | ((va == vb) & (ia < ib))


def lane_merge_topd(iou: np.ndarray, d: int):
    """Top-d of each row of ``iou`` (N, M) by the kernel's rule:
    lane-strided insertion lists, then d butterfly arg-max rounds."""
    rows, cols = iou.shape
    lv = np.full((LANES, rows, d), -1.0, np.float32)
    li = np.full((LANES, rows, d), PAD_ID, np.int64)
    for lane in range(LANES):
        v, ix = lv[lane], li[lane]
        for j in range(lane, cols, LANES):
            val = iou[:, j]
            for s in range(d - 1, -1, -1):
                take = v[:, s] < val
                if s > 0:
                    up = v[:, s - 1] < val
                    new_v = np.where(up, v[:, s - 1], val)
                    new_i = np.where(up, ix[:, s - 1], j)
                else:
                    new_v, new_i = val, j
                v[:, s] = np.where(take, new_v, v[:, s])
                ix[:, s] = np.where(take, new_i, ix[:, s])
    head = np.zeros((LANES, rows), np.int64)       # popped per lane
    lane_ids = np.arange(LANES)
    out_v = np.empty((rows, d), np.float32)
    out_i = np.empty((rows, d), np.int64)
    r_idx = np.arange(rows)
    for r in range(d):
        safe = np.minimum(head, d - 1)
        bv = np.where(head < d, lv[lane_ids[:, None], r_idx, safe], -1.0)
        bi = np.where(head < d, li[lane_ids[:, None], r_idx, safe], PAD_ID)
        off = 16
        while off:
            ov, oi = bv[lane_ids ^ off], bi[lane_ids ^ off]
            take = _before(ov, oi, bv, bi)
            bv, bi = np.where(take, ov, bv), np.where(take, oi, bi)
            off >>= 1
        # every lane holds the same winner
        assert (bv == bv[0]).all() and (bi == bi[0]).all()
        out_v[:, r], out_i[:, r] = bv[0], bi[0]
        real = bi[0] != PAD_ID
        head[bi[0][real] % LANES, r_idx[real]] += 1
    return out_v, out_i


def _tie_heavy(seed: int, n_a: int, m_b: int, n_dup: int):
    """Anchors and candidates on a small field (many overlaps and many
    zero IoUs), with exact duplicate candidates and masked rows."""
    rng = np.random.default_rng(seed)
    xa = rng.uniform(0, 900.0, (n_a, 2)).astype(np.float32)
    xb = rng.uniform(0, 900.0, (m_b, 2)).astype(np.float32)
    # duplicated boxes: equal IoUs at different indices
    src = rng.integers(0, m_b, n_dup)
    dst = rng.integers(0, m_b, n_dup)
    xb[dst] = xb[src]
    # some candidates sit exactly on anchors (IoU 1.0 ties)
    xb[rng.integers(0, m_b, 4)] = xa[rng.integers(0, n_a, 4)]
    ma = rng.uniform(size=n_a) > 0.1
    mb = rng.uniform(size=m_b) > 0.2
    return xa, ma, xb, mb


CASES = [(0, 40, 70, 20), (1, 33, 257, 90), (2, 64, 95, 60)]


@pytest.mark.parametrize("d", [1, 5, 8, 16, 24])
@pytest.mark.parametrize("case", CASES)
def test_lane_merge_equals_neighbor_lists(case, d):
    """Kernel 1's convention (masked pairs -1, never listed; empty
    slots -1 with the sentinel index M): the model equals the plain
    version and the Pallas kernel in interpret mode."""
    seed, n_a, m_b, n_dup = case
    xa, ma, xb, mb = _tie_heavy(seed, n_a, m_b, n_dup)
    plain_v, plain_i, _ = tk.topk_neighbors_plain(
        t(xa), t(ma), t(xb), t(mb), BOX, BOX, d=d, threshold=0.3)
    iou = n(pair_iou(t(xa), t(xb), BOX))
    iou = np.where(ma[:, None] & mb[None, :], iou, np.float32(-1.0))
    assert (iou == 0.0).sum() > iou.size // 4      # zero-IoU ties abound
    got_v, got_i = lane_merge_topd(iou, d)
    got_i = np.where(got_v > -1.0, got_i, m_b)
    np.testing.assert_array_equal(got_v, n(plain_v))
    np.testing.assert_array_equal(got_i, n(plain_i))
    want = pallas_topk_neighbors(
        jnp.asarray(xa), jnp.asarray(ma), jnp.asarray(xb), jnp.asarray(mb),
        BOX, BOX, d=d, threshold=0.3, tile_m=64, tile_n=128,
        interpret=True,
    )
    np.testing.assert_array_equal(got_v, n(want[0]))
    np.testing.assert_array_equal(got_i, n(want[1]))


@pytest.mark.parametrize("d", [1, 8, 16, 24])
@pytest.mark.parametrize("case", CASES[:2])
def test_lane_merge_equals_clique_lists(case, d):
    """Kernel 2's convention (masked pairs 0.0, so every list is full):
    the model equals ``lax.top_k`` and the plain ``dense_neighbors``."""
    seed, n_a, m_b, n_dup = case
    xa, ma, xb, mb = _tie_heavy(seed, n_a, m_b, n_dup)
    k_xy = np.zeros((1, 2, max(n_a, m_b), 2), np.float32)
    k_mask = np.zeros((1, 2, max(n_a, m_b)), bool)
    k_xy[0, 0, :n_a], k_xy[0, 1, :m_b] = xa, xb
    k_mask[0, 0, :n_a], k_mask[0, 1, :m_b] = ma, mb
    sizes = torch.full((2,), BOX)
    vals, idxs, _ = dense_neighbors(t(k_xy), t(k_mask), sizes, 0.3, d)
    iou = n(pair_iou(t(k_xy[0, 0]), t(k_xy[0, 1]), BOX))
    iou = np.where(k_mask[0, 0][:, None] & k_mask[0, 1][None, :], iou,
                   np.float32(0.0))
    got_v, got_i = lane_merge_topd(iou, d)
    assert (got_i != PAD_ID).all()
    np.testing.assert_array_equal(got_v, n(vals[0][0]))
    np.testing.assert_array_equal(got_i, n(idxs[0][0]))
    want_v, want_i = jax.lax.top_k(jnp.asarray(iou), d)
    np.testing.assert_array_equal(got_v, n(want_v))
    np.testing.assert_array_equal(got_i, n(want_i))


def buffer_rank_topd(iou: np.ndarray, mask_b: np.ndarray, d: int,
                     tile: int):
    """Top-d of each row of ``iou`` (N, M; masked pairs -1) by kernel
    1's rule for d <= 32: unmasked candidates compacted per tile, in
    batches of 32; positives above the d-th buffered value appended to
    a buffer that keeps its top d once it holds more than 32; the first
    d zeros apart; ranks on (value desc, index asc) place the
    positives, the zeros follow."""
    rows, cols = iou.shape
    out_v = np.full((rows, d), -1.0, np.float32)
    out_i = np.full((rows, d), cols, np.int64)

    def top(vals, ids):
        # rank = entries ahead on the key; ranks below d, in rank order
        rank = [sum(_before(vals[j], ids[j], vals[e], ids[e])
                    for j in range(len(vals))) for e in range(len(vals))]
        order = sorted(range(len(vals)), key=rank.__getitem__)[:d]
        return [vals[e] for e in order], [ids[e] for e in order]

    for row in range(rows):
        bv, bi, vmin = [], [], np.float32(0.0)
        for t0 in range(0, cols, tile):
            ids = t0 + np.flatnonzero(mask_b[t0:t0 + tile])
            for jb in range(0, ids.size, LANES):
                for j in ids[jb:jb + LANES]:
                    if iou[row, j] > vmin:
                        bv.append(iou[row, j])
                        bi.append(j)
                if len(bv) > KBUF - LANES:
                    bv, bi = top(bv, bi)
                    if d > 0:
                        vmin = bv[d - 1]
        bv, bi = top(bv, bi)
        zeros = np.flatnonzero(mask_b & (iou[row] == 0.0))[:d - len(bv)]
        out_v[row, :len(bv)], out_i[row, :len(bv)] = bv, bi
        out_v[row, len(bv):len(bv) + zeros.size] = 0.0
        out_i[row, len(bv):len(bv) + zeros.size] = zeros
    return out_v, out_i


def warp_list_topd(iou: np.ndarray, mask_b: np.ndarray, d: int):
    """Kernel 1's rule for d > 32: one sorted list per anchor, candidates
    offered in index order, inserted above the d-th value after every
    listed value >= theirs."""
    rows, cols = iou.shape
    out_v = np.full((rows, d), -1.0, np.float32)
    out_i = np.full((rows, d), cols, np.int64)
    for row in range(rows):
        v, ix = out_v[row], out_i[row]
        fill = 0
        for j in np.flatnonzero(mask_b):
            val = iou[row, j]
            vmin = v[d - 1] if fill == d else -1.0
            if not val > vmin:
                continue
            p = int((v[:fill] >= val).sum())
            last = min(fill, d - 1)
            v[p + 1:last + 1] = v[p:last].copy()
            ix[p + 1:last + 1] = ix[p:last].copy()
            v[p], ix[p] = val, j
            fill = min(fill + 1, d)
    return out_v, out_i


@pytest.mark.parametrize("tile", [KERNEL_TILE, 64])
@pytest.mark.parametrize("d", [1, 5, 8, 16, 32])
@pytest.mark.parametrize("case", CASES)
def test_buffer_rank_equals_neighbor_lists(case, d, tile):
    """Kernel 1's rule for d <= 32 equals the plain version; the
    tie-heavy field gives anchors more than 32 positive IoUs, so the
    buffer keeps its top d mid-scan."""
    seed, n_a, m_b, n_dup = case
    xa, ma, xb, mb = _tie_heavy(seed, n_a, m_b, n_dup)
    plain_v, plain_i, _ = tk.topk_neighbors_plain(
        t(xa), t(ma), t(xb), t(mb), BOX, BOX, d=d, threshold=0.3)
    iou = n(pair_iou(t(xa), t(xb), BOX))
    iou = np.where(ma[:, None] & mb[None, :], iou, np.float32(-1.0))
    got_v, got_i = buffer_rank_topd(iou, mb, d, tile)
    np.testing.assert_array_equal(got_v, n(plain_v))
    np.testing.assert_array_equal(got_i, n(plain_i))


def test_tie_heavy_cases_fill_the_buffer():
    """At least one case overflows the 64-slot buffer's trigger."""
    xa, ma, xb, mb = _tie_heavy(*CASES[1])
    iou = n(pair_iou(t(xa), t(xb), BOX))
    pos = ((iou > 0) & ma[:, None] & mb[None, :]).sum(1)
    assert pos.max() > KBUF - LANES


@pytest.mark.parametrize("d", [33, 48])
@pytest.mark.parametrize("case", CASES)
def test_warp_list_equals_neighbor_lists(case, d):
    seed, n_a, m_b, n_dup = case
    xa, ma, xb, mb = _tie_heavy(seed, n_a, m_b, n_dup)
    plain_v, plain_i, _ = tk.topk_neighbors_plain(
        t(xa), t(ma), t(xb), t(mb), BOX, BOX, d=d, threshold=0.3)
    iou = n(pair_iou(t(xa), t(xb), BOX))
    iou = np.where(ma[:, None] & mb[None, :], iou, np.float32(-1.0))
    got_v, got_i = warp_list_topd(iou, mb, d)
    np.testing.assert_array_equal(got_v, n(plain_v))
    np.testing.assert_array_equal(got_i, n(plain_i))
