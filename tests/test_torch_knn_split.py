"""The k-NN kernel's split of the work (K7), in plain PyTorch.

On the card, ``knn.knn`` cuts the call's (query unit, ref tile) pairs into
equal runs, one a block; a run that crosses units gives each unit's part,
a segment of its refs, its own top-k, and the segments' lists are merged
(csrc/knn.cu). ``tests/knn_split.py``'s ``topk_split_reference`` does the
same in plain PyTorch at small units and tiles; here it is held bit for
bit to the plain version of the whole, ``topk_neighbors_reference``, and
to the JAX package's ``_tiled_topk_neighbors`` (its XLA path, run as
tests/test_torch_knn.py runs it). Against JAX: bit for bit on integer lattices, where every
product and sum is exact, so the two frameworks round nothing and only the
order of ties is tested; on random clouds the distances within rtol =
1e-5, atol = 1e-4 (JAX's dot may round its 3-wide sum in another order),
as in tests/test_torch_knn.py. JAX fills a slot it cannot fill with index 0
only within one of its tiles, so those cases run it at one tile.
"""

import numpy as np
import pytest
import torch

from knn_split import segments, topk_split_reference  # tests/knn_split.py
from tests.test_torch_convert import t
from tests.test_torch_knn import TOL, _jax_topk, _random_cloud
from tpu3dssf_torch.voxel.voxelize import (KNN_BAD_DIST,
                                          topk_neighbors_reference)

K_ALL = list(range(1, 9))
# (blocks, tile, unit) of the split: few and many blocks, tiles that cut
# the refs anywhere or at multiples of 16 and 64, units of queries that cut
# the queries raggedly
SPLITS = [(2, 1, 64), (3, 16, 16), (7, 1, 25), (5, 64, 7), (40, 8, 32),
          (1000, 4, 13)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lattice(rng, B, Q, R, masked=0.2, side=6):
    """Integer points in [0, side)³: exact f32 arithmetic and many exact
    ties, so every tie crosses slice boundaries somewhere."""
    q = rng.integers(0, side, size=(B, Q, 3)).astype(np.float32)
    r = rng.integers(0, side, size=(B, R, 3)).astype(np.float32)
    return q, r, rng.random((B, R)) > masked


def _split_equals_plain(q, r, m, k, splits=SPLITS):
    want = topk_neighbors_reference(t(q), t(r), t(m), k)
    for blocks, tile, unit in splits:
        got = topk_split_reference(t(q), t(r), t(m), k, blocks, tile, unit)
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
        assert torch.equal(got[0], want[0]), (blocks, tile, unit)
        assert torch.equal(got[1], want[1]), (blocks, tile, unit)
    return want


@pytest.mark.parametrize("k", K_ALL)
def test_split_matches_plain_and_jax_on_random_clouds(rng, k):
    q, r, m = _random_cloud(rng, 2, 60, 203)
    d, i = _split_equals_plain(q, r, m, k)
    want_d, _ = _jax_topk(q, r, m, k)
    np.testing.assert_allclose(d.numpy(), want_d, **TOL)


@pytest.mark.parametrize("k", K_ALL)
def test_split_matches_plain_and_jax_bit_for_bit_on_a_lattice(rng, k):
    q, r, m = _lattice(rng, 2, 50, 230)
    d, i = _split_equals_plain(q, r, m, k)
    want_d, want_i = _jax_topk(q, r, m, k)
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(i.numpy(), want_i)


@pytest.mark.parametrize("k", K_ALL)
def test_duplicated_refs_in_different_slices_go_to_the_lower_index(rng, k):
    q, r, _ = _lattice(rng, 1, 40, 240, side=5)
    r[0, 200:240] = r[0, 0:40]          # the same points in the last slice
    r[0, 120:160] = r[0, 0:40]          # and in a middle one
    m = np.ones((1, 240), bool)
    d, i = _split_equals_plain(q, r, m, k)
    want_d, want_i = _jax_topk(q, r, m, k)
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(i.numpy(), want_i)
    # a copy enters only after its original and its copy in a lower slice
    for row in i[0].tolist():
        for slot, j in enumerate(row):
            for first in (0, 120, 200):
                if first < j < first + 40 or j == first:
                    lower = [c for c in (0, 120, 200) if c < first]
                    assert all(j - first + c in row[:slot] for c in lower)


@pytest.mark.parametrize("k", K_ALL)
def test_empty_slices_and_samples_with_fewer_than_k_refs(rng, k):
    """Sample 0 has no valid ref; sample 1 has 3, all in its last slices;
    sample 2 has refs only in one middle slice. Slots left over hold
    (KNN_BAD_DIST, 0) as in the plain version and JAX."""
    q, r, _ = _lattice(rng, 3, 30, 90)
    m = np.zeros((3, 90), bool)
    m[1, [70, 81, 89]] = True
    m[2, 40:50] = True
    d, i = _split_equals_plain(q, r, m, k)
    want_d, want_i = _jax_topk(q, r, m, k, tile=2048)
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(i.numpy(), want_i)
    assert (d[0] == KNN_BAD_DIST).all() and (i[0] == 0).all()
    assert (d[1, :, 3:] == KNN_BAD_DIST).all() and (i[1, :, 3:] == 0).all()
    assert set(i[1, :, :min(k, 3)].flatten().tolist()) <= {70, 81, 89}


@pytest.mark.parametrize("units,tiles,blocks", [
    (4, 68, 528), (4, 68, 132), (1, 3, 7), (3, 1, 2), (5, 7, 1), (2, 9, 9),
    (272, 68, 528)])
def test_segments_cover_every_tile_once_in_equal_runs(units, tiles, blocks):
    """Every unit's segments tile its refs in order; the runs differ by at
    most one tile, and more blocks than tiles leave none empty."""
    segs = segments(units, tiles, blocks)
    for unit in segs:
        assert unit[0][0] == 0 and unit[-1][1] == tiles
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(unit,
                                                               unit[1:]))
    total = units * tiles
    runs = [(p + 1) * total // min(blocks, total) - p * total
            // min(blocks, total) for p in range(min(blocks, total))]
    assert sum(runs) == total and max(runs) - min(runs) <= 1 and min(runs)


@pytest.mark.parametrize("R,blocks,tile", [
    (50, 7, 1), (50, 3, 16), (5, 9, 1), (1, 4, 1), (64, 4, 16),
    (129, 2, 64), (1031, 3, 512)])
def test_ragged_splits_are_exact(rng, R, blocks, tile):
    """R not a multiple of the tile, R below the number of blocks, Q not a
    multiple of the unit."""
    q, r, m = _random_cloud(rng, 2, 21, R, masked=0.1)
    k = min(5, R)
    _split_equals_plain(q, r, m, k, splits=[(blocks, tile, 8)])
