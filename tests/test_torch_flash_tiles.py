"""PyTorch port: the tile bounds and (query block, key tile) pair classes
that the segment branch of the flash kernels (B1, B2, B3) walks by.

``tile_bounds`` gives each 64-token tile's [id min, id max, position min,
position max]; ``pair_classes`` turns a query block's and a key tile's
bounds into SKIP (no pair inside can be visible), FULL (every pair inside
is visible, so the kernel runs it without a mask) or MASKED. The CUDA
kernels (``flash_seg.cuh`` ``pair_class``) apply the same rule on the card,
where ``tests/test_torch_cuda_kernels.py`` holds their outputs and
gradients against the plain pair. Here, on the CPU, the rule itself is
held against the segment mask (``_block_mask`` of the Pallas kernels:
equal ids and, if causal, q_pos >= kv_pos) over every pair of a block: a
visible pair never lies in a SKIP pair, and every pair of a FULL pair is
visible. Inputs are
seeded numpy draws and the varlen phase's patterns V1, V2 and V3
(``chip_smoke.py``), at the blocks of B1 and B2 (64 / G positions) and B3
(64).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa

_ROOT = pathlib.Path(__file__).parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _packed(lens_q, lens_k):
    cu = lambda ls: torch.tensor(np.concatenate([[0], np.cumsum(ls)]),
                                 dtype=torch.int32)
    segs = fa.varlen_segments(cu(lens_q), cu(lens_k), int(sum(lens_q)),
                              int(sum(lens_k)), torch.device("cpu"))
    return tuple(t[None] for t in segs)


def _pattern(name):
    """(q ids, kv ids, q positions, kv positions), int32 [B, S]."""
    rng = np.random.default_rng(sum(map(ord, name)))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32)
    if name == "V1":
        cs = _chip_smoke()
        lens = cs.varlen_lengths(6, cs.V1_TOKENS, cs.V1_LONGEST)
        return _packed(lens, lens)
    if name == "V2":
        cs = _chip_smoke()
        lens_k = cs.varlen_lengths(7, cs.V2_TOKENS, cs.V2_LONGEST)
        lens_q = [min(n, 64) for n in lens_k]
        lens_q[1] = 0
        return _packed(lens_q, lens_k)
    if name == "V3":
        S = 2048
        pos = np.arange(S)
        kv = np.broadcast_to((pos // 96) % 3, (2, S))
        q = kv.copy()
        q[:, S // 2:S // 2 + 40] = 3
        p = np.broadcast_to(pos, (2, S))
        return t(q), t(kv), t(p), t(p)
    if name == "random-packed":  # random lengths, some of them 0 or 1
        lens = rng.integers(0, 300, size=12)
        return _packed(lens, lens)
    if name == "random-cross":   # queries the last few tokens of each
        lens_k = rng.integers(1, 400, size=8)
        lens_q = np.minimum(lens_k, rng.integers(0, 100, size=8))
        return _packed(lens_q, lens_k)
    if name == "random-ids":     # non-monotone ids in short runs
        S = 700
        kv = np.repeat(rng.integers(0, 3, size=S // 7 + 1), 7)[:S]
        kv = np.stack([kv, np.roll(kv, 50)])
        q = kv.copy()
        q[:, 100:130] = 9        # orphan queries
        p = np.broadcast_to(np.arange(S), (2, S))
        return t(q), t(kv), t(p), t(p)
    assert name == "random-positions"  # one id, positions out of order
    S = 500
    ids = np.zeros((2, S))
    qp = np.stack([rng.permutation(S), np.arange(S) + 64])
    kp = np.stack([rng.permutation(S), np.arange(S)])
    return t(ids), t(ids), t(qp), t(kp)


_PATTERNS = ["V1", "V2", "V3", "random-packed", "random-cross", "random-ids",
             "random-positions"]


def _block_any_all(vis, bq, bk):
    """any and all of the visibility ``vis`` [B, Sq, Sk] over each
    (bq-row, bk-key) block; the ragged edge counts as invisible for any
    and as visible for all."""
    B, Sq, Sk = vis.shape
    nq, nk = -(-Sq // bq), -(-Sk // bk)

    def pad(fill):
        out = torch.full((B, nq * bq, nk * bk), fill, dtype=torch.bool)
        out[:, :Sq, :Sk] = vis
        return out.view(B, nq, bq, nk, bk)
    return pad(False).any(4).any(2), pad(True).all(4).all(2)


@pytest.mark.parametrize("block", [1, 16, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", _PATTERNS)
def test_pair_classes_hold_the_segment_mask(name, causal, block):
    qseg, kseg, qpos, kpos = _pattern(name)
    cls = fa.pair_classes(fa.tile_bounds(qseg, qpos, block),
                          fa.tile_bounds(kseg, kpos), causal)
    vis = qseg[:, :, None] == kseg[:, None, :]
    if causal:
        vis &= qpos[:, :, None] >= kpos[:, None, :]
    any_vis, all_vis = _block_any_all(vis, block, 64)
    assert cls.shape == any_vis.shape
    # a visible pair never lies in a SKIP pair ...
    assert not bool((any_vis & (cls == fa.SKIP)).any())
    # ... and a FULL pair holds visible pairs only
    assert bool(all_vis[cls == fa.FULL].all())
    # a pair with no visible entry is never FULL
    assert not bool(((cls == fa.FULL) & ~any_vis).any())


@pytest.mark.parametrize("name", ["V1", "V3"])
def test_varlen_patterns_reach_skip_and_full_pairs(name):
    """The position skip and the unmasked interior apply where the varlen
    phase measures them: V1 (long packed sequences) has FULL pairs and
    pairs skipped inside a segment by position; V3 has pairs skipped by
    position that the id ranges alone would walk."""
    qseg, kseg, qpos, kpos = _pattern(name)
    qb, kb = fa.tile_bounds(qseg, qpos), fa.tile_bounds(kseg, kpos)
    cls = fa.pair_classes(qb, kb, True)
    ids_overlap = fa.pair_classes(qb, kb, False) != fa.SKIP
    by_position = ids_overlap & (cls == fa.SKIP)
    assert int(by_position.sum()) > 0
    if name == "V1":
        assert int((cls == fa.FULL).sum()) > int((cls == fa.MASKED).sum())
    # causal skipping walks at most about half of what the ids allow
    assert int((cls != fa.SKIP).sum()) < 0.6 * int(ids_overlap.sum())


def test_tile_bounds_pad_the_ragged_tile_with_its_last_token():
    ids = torch.tensor([[3, 3, 1, 1, 1, 2, 2]], dtype=torch.int32)
    pos = torch.tensor([[5, 6, 0, 1, 2, 0, 1]], dtype=torch.int32)
    b = fa.tile_bounds(ids, pos, block=3)
    assert b.dtype == torch.int32 and b.is_contiguous()
    # rows: id min, id max, position min, position max; one column a tile
    assert b.tolist() == [[[1, 1, 2], [3, 2, 2], [0, 0, 1], [6, 2, 1]]]


def test_pair_class_cases():
    # columns of (id min, id max, pos min, pos max)
    q = torch.tensor([[0, 0, 64, 127], [0, 0, 0, 63], [0, 1, 64, 127],
                      [2, 2, 0, 63]], dtype=torch.int32).T
    k = torch.tensor([[0, 0, 0, 63]], dtype=torch.int32).T
    assert fa.pair_classes(q, k, True)[:, 0].tolist() == [
        fa.FULL,     # one id, every query after every key
        fa.MASKED,   # one id, on the diagonal
        fa.MASKED,   # two ids
        fa.SKIP]     # no id in common
    k2 = torch.tensor([[0, 0, 128, 191]], dtype=torch.int32).T
    assert fa.pair_classes(q, k2, True)[:, 0].tolist() == [fa.SKIP] * 4
    assert fa.pair_classes(q, k2, False)[:, 0].tolist() == [
        fa.FULL, fa.FULL, fa.MASKED, fa.SKIP]


@pytest.mark.parametrize("B,Hk,G,Sk,want", [
    (1, 8, 4, 2048, 2),    # Llama-3-8B, B 1, S 2048: 256 CTAs -> 512
    (8, 16, 1, 1024, 1),   # GPT-2 medium: no group to split
    (1, 8, 4, 8192, 2),    # V1: 1024 CTAs -> 2048
    (1, 2, 8, 100, 2),
    (1, 1, 64, 64, 2),
    (8, 8, 4, 2048, 1),    # 2048 CTAs: enough
    (1, 4, 3, 64, 1),      # an odd group
])
def test_dkv_cluster(B, Hk, G, Sk, want):
    assert fa.dkv_cluster(B, Hk, G, Sk) == want


@pytest.mark.parametrize("B,Hk,G,Sk,D,want", [
    (1, 4, 4, 2048, 256, 2),   # D 256, B 1, S 2048: 128 CTAs -> 256
    (1, 8, 2, 4096, 256, 1),   # V4 (Gemma-2 9B's heads): 512, 4 waves
    (1, 8, 2, 2048, 256, 2),   # 256 CTAs: below two waves
    (1, 8, 1, 2048, 256, 1),   # no group to split
    (1, 4, 4, 2048, 384, 1),   # above 256: column slices, no cluster
    (1, 4, 4, 2048, 512, 1),
])
def test_dkv_cluster_by_head_dim(B, Hk, G, Sk, D, want):
    assert fa.dkv_cluster(B, Hk, G, Sk, D) == want


@pytest.mark.parametrize("block", [1, 8, 16, 64])
@pytest.mark.parametrize("name", ["V2", "random-cross", "random-ids"])
def test_forward_block_bounds_ignore_rows_past_sq(name, block):
    """A query block's bounds (B1 and B2 reduce their own on the card over
    the block's live positions) cover its rows before Sq only: the ragged
    last block's padding repeats its last real row and adds nothing."""
    qseg, _, qpos, _ = _pattern(name)
    S = qseg.shape[1]
    b = fa.tile_bounds(qseg, qpos, block)
    assert b.shape[2] == -(-S // block)
    for t in range(b.shape[2]):
        ids = qseg[:, t * block:min(S, (t + 1) * block)]
        pos = qpos[:, t * block:min(S, (t + 1) * block)]
        want = torch.stack([ids.amin(1), ids.amax(1), pos.amin(1),
                            pos.amax(1)], 1)
        assert torch.equal(b[:, :, t], want)


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("name", ["V1", "V3"])
def test_forward_blocks_reach_every_pair_class(name, G):
    """The forward's folded blocks (64 / G positions: 64, 16, 8) against
    64-key tiles reach SKIP, FULL and MASKED pairs on the varlen phase's
    V1 and V3, causal, so the chip run times every path of B1-seg."""
    qseg, kseg, qpos, kpos = _pattern(name)
    cls = fa.pair_classes(fa.tile_bounds(qseg, qpos, 64 // G),
                          fa.tile_bounds(kseg, kpos), True)
    assert set(cls.unique().tolist()) == {fa.SKIP, fa.MASKED, fa.FULL}
