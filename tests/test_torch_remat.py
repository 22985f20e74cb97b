"""PTv3's remat flags in the port vs the JAX package's, on the CPU.

``remat`` checkpoints every PTv3 block and ``remat_attention`` every
block's attention branch (JAX's ``nn.remat(PTv3Block)`` and
``nn.remat(SerializedAttention)``). A 3-stage PTv3 at small widths
(windows 32/16, channels ≤ 64) runs with each flag in both frameworks on
the same numpy inputs and converted weights: the forward and the gradient
of every parameter, at the tolerance of tests/test_torch_ptv3.py (atol =
rtol = 1e-4: f32 sums over many layers in another order). Then the port
with and without each flag at drop_path 0.3 from one seed: forward and
gradients bit-identical, and the attention branch run twice per block (the
recompute) where a flag is on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_convert import port_config, t, to_numpy_tree
from tests.test_torch_ptv3 import MODEL_TOL, _inputs, _jax_config
from tpu3dssf.models import ptv3 as jptv3
from tpu3dssf_torch import convert
from tpu3dssf_torch.models import ptv3

FLAGS = ("remat", "remat_attention")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flag", FLAGS)
def test_remat_matches_jax_forward_and_gradients(rng, flag):
    jcfg = _jax_config(**{flag: True})
    feat, grid, mask = _inputs(rng, unique=True)
    proj = rng.normal(size=(2, 128, jcfg.dec_channels[0])).astype(np.float32)
    jin = [jnp.asarray(x) for x in (feat, grid, mask)]
    jmodel = jptv3.PointTransformerV3(jcfg)
    params = to_numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                *jin))

    def objective(p):
        out, _ = jmodel.apply(p, *jin)
        return (out * proj).sum(), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        params)

    model = ptv3.PointTransformerV3(port_config(jcfg, ptv3.PTv3Config))
    assert getattr(model.config, flag)
    model.load_state_dict(convert.state_dict_from_flax(params))
    got, _ = model(t(feat), t(grid), t(mask))
    (got * t(proj)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    want_grads = convert.state_dict_from_flax(to_numpy_tree(jgrads))
    names = dict(model.named_parameters())
    assert set(want_grads) == set(names)
    for k, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(),
                                   err_msg=k, **MODEL_TOL)


def _attention_calls(model):
    """A counter of SerializedAttention forwards, by pre-forward hooks (a
    recompute stops once it has what the backward needs, before the
    branch returns)."""
    calls = [0]

    def hook(*_):
        calls[0] += 1

    for m in model.modules():
        if isinstance(m, ptv3.SerializedAttention):
            m.register_forward_pre_hook(hook)
    return calls


@pytest.mark.parametrize("flags,runs_per_block", [
    (dict(remat=True), 2), (dict(remat_attention=True), 2),
    (dict(remat=True, remat_attention=True), 3)],
    ids=lambda f: "+".join(f) if isinstance(f, dict) else str(f))
def test_remat_changes_no_bit_with_drop_path(rng, flags, runs_per_block):
    """The same seeded DropPath masks with and without remat: they are an
    input of the forward, so the recompute sees them too. Each flag recomputes the attention branch once in the backward;
    both nest, as in JAX, and the block's recompute runs the branch's
    checkpoint again."""
    from tpu3dssf_torch.models.layers import init_weights

    base = port_config(_jax_config(drop_path=0.3), ptv3.PTv3Config)
    feat, grid, mask = (t(x) for x in _inputs(rng, unique=True))
    proj = t(rng.normal(size=(2, 128, base.dec_channels[0]))
             .astype(np.float32))
    blocks = sum(base.enc_depths) + sum(base.dec_depths)
    runs = []
    for cfg in (base, dataclasses.replace(base, **flags)):
        model = init_weights(ptv3.PointTransformerV3(cfg), 3)
        calls = _attention_calls(model)
        keep = model.draw_keep(feat.shape[0],
                               torch.Generator().manual_seed(11))
        out, _ = model(feat, grid, mask, keep=keep)
        (out * proj).sum().backward()
        runs.append((out.detach(), {k: p.grad for k, p in
                                    model.named_parameters()}, calls[0]))
    (out0, grads0, calls0), (out1, grads1, calls1) = runs
    # DropPath dropped something: the masks are in play
    off = init_weights(ptv3.PointTransformerV3(base), 3)(feat, grid, mask)[0]
    assert not torch.equal(off, out0)
    torch.testing.assert_close(out1, out0, rtol=0, atol=0)
    assert grads1.keys() == grads0.keys()
    for k in grads0:
        torch.testing.assert_close(grads1[k], grads0[k], rtol=0, atol=0,
                                   msg=k)
    # each checkpointed attention branch runs again in the backward
    assert calls0 == blocks and calls1 == runs_per_block * blocks


def test_remat_is_off_without_a_gradient(rng):
    """Eval (no gradient pending) checkpoints nothing: one attention
    forward per block, the same output as without the flag."""
    from tpu3dssf_torch.models.layers import init_weights

    base = port_config(_jax_config(), ptv3.PTv3Config)
    feat, grid, mask = (t(x) for x in _inputs(rng, unique=True))
    outs = []
    for cfg in (base, dataclasses.replace(base, remat=True)):
        model = init_weights(ptv3.PointTransformerV3(cfg), 3)
        calls = _attention_calls(model)
        with torch.no_grad():
            outs.append(model(feat, grid, mask)[0])
        assert calls[0] == sum(base.enc_depths) + sum(base.dec_depths)
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)

