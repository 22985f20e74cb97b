"""The port's PointTransformerV3 vs the JAX package's, on converted weights.

A 3-stage PTv3 at small widths (windows 32/16) runs in both frameworks on
the same inputs; the JAX side takes its plain attention path
(``use_pallas=False``). Tolerances: the whole model at atol = rtol = 1e-4
(f32 sums over many layers in another order); pooling structure, slots
and permutations exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_convert import port_config, t, to_numpy_tree
from tpu3dssf.models import ptv3 as jptv3
from tpu3dssf.serialization import argsort_lex, serialization_keys
from tpu3dssf_torch import convert
from tpu3dssf_torch.models import ptv3

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_config(**kw):
    base = dict(enc_depths=(2, 1, 2), enc_channels=(16, 32, 64),
                enc_heads=(1, 2, 4), enc_window=(32, 16, 16),
                dec_depths=(1, 2), dec_channels=(16, 32), dec_heads=(1, 2),
                dec_window=(32, 16), use_pallas=False)
    base.update(kw)
    return jptv3.PTv3Config(**base)


def _inputs(rng, unique, B=2, N=128):
    """Voxel-like inputs: distinct cells (what voxelize emits) or raw
    floored points with duplicate cells; the tail is padding."""
    grid = np.zeros((B, N, 3), np.int32)
    for b in range(B):
        cells = rng.integers(-6, 6, size=(4 * N, 3))
        if unique:
            cells = np.unique(cells, axis=0)
            cells = cells[rng.permutation(len(cells))]
        grid[b] = cells[:N]
    feat = np.concatenate([grid * 0.5 + rng.random((B, N, 3)) * 0.5,
                           rng.random((B, N, 1))], -1).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[0, N - 20:] = False
    mask[1, N - 70:] = False
    return feat, grid, mask


@pytest.mark.parametrize("unique,collapse", [(True, True), (True, False),
                                             (False, True)])
def test_ptv3_matches_jax_on_converted_weights(rng, unique, collapse):
    jcfg = _jax_config(unique_cells=unique, collapse_pooled_orders=collapse)
    feat, grid, mask = _inputs(rng, unique)
    jmodel = jptv3.PointTransformerV3(jcfg)
    params = to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), feat, grid, mask))
    want, _ = jax.jit(jmodel.apply)(params, feat, grid, mask)

    model = ptv3.PointTransformerV3(port_config(jcfg, ptv3.PTv3Config))
    model.load_state_dict(convert.state_dict_from_flax(params))
    with torch.no_grad():
        got, _ = model(t(feat), t(grid), t(mask))
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def _sorted_stream(rng, unique):
    _, grid, mask = _inputs(rng, unique, N=64)
    order = np.stack([np.asarray(argsort_lex(
        *serialization_keys(jnp.asarray(g), "z"), jnp.asarray(m)))
        for g, m in zip(grid, mask)])
    grid = np.take_along_axis(grid, order[..., None], 1)
    mask = np.take_along_axis(mask, order, 1)
    h = rng.normal(size=(2, 64, 8)).astype(np.float32)
    return grid, mask, h


@pytest.mark.parametrize("unique", [True, False])
def test_pool_structure_sorted_and_run_max(rng, unique):
    # duplicate cells (unique=False) take the exact segment max in the
    # model; the structure itself must match either way
    grid, mask, h = _sorted_stream(rng, unique)
    got = ptv3._pool_structure_sorted(t(grid), t(mask), 32)
    want = jptv3._pool_structure_sorted(jnp.asarray(grid), jnp.asarray(mask),
                                        32)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    seg, end_pos = got[0], got[5]
    pooled = ptv3._run_max_sorted(t(h), seg, end_pos, got[2])
    jpooled = jax.vmap(jptv3._run_max_sorted)(jnp.asarray(h), want[0],
                                              want[5])
    np.testing.assert_array_equal(pooled.numpy(), np.asarray(jpooled))
