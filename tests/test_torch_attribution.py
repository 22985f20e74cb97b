"""The attribution CLIs (``tpu3dssf_torch/cli/attr_bwd.py``,
``time_ptv3_parts.py``, ``time_block_glue.py``, ``time_loss_parts.py``) on
the CPU at a tiny PTv3 (two stages, widths 16 and 32, 128 voxels), one
repeat a piece: every piece of the JAX script has its row, and the sums
are the depth-weighted sums of the rows. Two pieces' functions are held
against the JAX package at f32 on the same inputs: a ``PTv3Block``'s
forward + backward gradients against the JAX block's VJP on converted
weights (f32 sums in another order: atol = rtol = 1e-5 for the value and
the input's gradient; each weight's gradient, a sum over the 128 rows,
within rtol 1e-5 and 1e-5 of its largest entry), and the CE +
Lovász loss with its gradient against ``tpu3dssf.losses`` with
``exact_sort=True`` (atol = rtol = 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_convert import t, to_numpy_tree
from tpu3dssf_torch import convert
from tpu3dssf_torch.cli import (attr_bwd, time_block_glue, time_loss_parts,
                                time_ptv3_parts)

TINY = ["--device", "cpu", "--tiny", "--r", "1", "--replays", "1",
        "--warmup", "0"]
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pieces(record):
    return [r["piece"] for r in record["rows"]]


def _weighted(record, kind):
    return sum(r["depth"] * r[record["unit"]] for r in record["rows"]
               if r.get("kind") == kind)


def _check_rows(record, names):
    assert _pieces(record) == names
    for r in record["rows"]:
        assert np.isfinite(r[record["unit"]]) and r[record["unit"]] > 0, r
        assert r["r"] == 1 and r["launches"] == {}


@pytest.mark.parametrize("tiny", [True, False])
def test_step_launches_count_every_layer_norm_of_the_model(tiny):
    """The launches the attribution CLIs hold a whole PTv3 forward (and a
    train step) to take one LN (and one LNB) a LayerNorm module of the
    model built from the same config."""
    from tpu3dssf_torch.models.layers import LayerNorm
    from tpu3dssf_torch.models.ptv3 import PointTransformerV3, PTv3Config
    cfg = attr_bwd.tiny_config() if tiny else PTv3Config()
    with torch.device("meta"):
        norms = sum(isinstance(m, LayerNorm)
                    for m in PointTransformerV3(cfg).modules())
    assert attr_bwd.ptv3_norms(cfg) == norms == (12 if tiny else 57)
    step = attr_bwd.step_launches(cfg, 128 if tiny else 25600)
    forward = attr_bwd.step_launches(cfg, 128 if tiny else 25600, grad=False)
    assert step["LN"] == step["LNB"] == forward["LN"] == norms
    assert "LNB" not in forward


def test_attr_bwd_rows_and_sums(tmp_path):
    out = tmp_path / "attr.json"
    rec = attr_bwd.main(TINY + ["--out", str(out)])
    cfg = attr_bwd.tiny_config()
    names, shapes = [], set()
    for name, n, C, H, _, _ in attr_bwd.stages(cfg, 128):
        names += [f"{name} block fwd", f"{name} block fwd+bwd"]
        if (n, C, H) not in shapes:
            shapes.add((n, C, H))
            names += [f"{name} {sub} {kind}"
                      for sub in ("attn(perm)", "attn(none)", "cpe", "mlp")
                      for kind in ("fwd", "fwd+bwd")]
    for n, C in attr_bwd.TINY["gathers"]:
        names += [f"gather (N={n}, C={C}) {way}" for way in (
            "fwd alone", "permutation_gather fwd+bwd",
            "gather_rows fwd+bwd", "index_add_ fwd+bwd")]
    names += [f"pool1 (128->64) {k}" for k in ("fwd", "fwd+bwd")]
    names += [f"unpool0 (64->128) {k}" for k in ("fwd", "fwd+bwd")]
    names += [f"devox gather (192 pts -> 128 vox, 16) {k}"
              for k in ("fwd", "fwd+bwd")]
    names += [f"CE+Lovasz loss (384 pts) {k}" for k in ("fwd", "fwd+bwd")]
    from tpu3dssf_torch.cli.bench_train import row_config
    from tpu3dssf_torch.models.lidar_only import LidarSegmentationModel
    count = sum(q.numel() for q in LidarSegmentationModel(row_config(
        1, torch.float32, 128, cfg)).parameters())
    names += [f"AdamW ({count:,} params)"]
    _check_rows(rec, names)

    sums = rec["sums"]
    assert sums["block_fwd_depth_weighted"] == pytest.approx(
        _weighted(rec, "block_fwd"))
    assert sums["block_fwd_bwd_depth_weighted"] == pytest.approx(
        _weighted(rec, "block_fwd_bwd"))
    depths = {s[0]: s[5] for s in attr_bwd.stages(cfg, 128)}
    assert sums["block_fwd_bwd_depth_weighted"] == pytest.approx(sum(
        depths[r["stage"]] * r["ms"] for r in rec["rows"]
        if r["piece"].endswith("block fwd+bwd")))
    parts = sums["parts"]
    assert sums["sum_of_parts"] == pytest.approx(sum(parts.values()))
    for key, kind in (("pooling_fwd_bwd", "pool_fwd_bwd"),
                      ("unpooling_fwd_bwd", "unpool_fwd_bwd"),
                      ("loss_fwd_bwd", "loss_fwd_bwd"), ("adamw", "adamw")):
        assert parts[key] == pytest.approx(_weighted(rec, kind))
    for name in ("lidar-only", "fusion"):
        whole = sums["wholes"][name]
        assert whole["ms"] > 0 and whole["device_ms"] is None
        assert whole["remainder_ms"] == pytest.approx(
            whole["ms"] - sums["sum_of_parts"])
    assert out.read_text().strip() and '"tool": "attr_bwd"' in out.read_text()


def test_time_ptv3_parts_rows_and_sums():
    rec = time_ptv3_parts.main(TINY + ["--batch", "1"])
    cfg = attr_bwd.tiny_config()
    names = []
    for name, N, C, H, _, _ in attr_bwd.stages(cfg, 128):
        if name.startswith("enc"):
            names += [f"{name} window_attn N={N} C={C} h={H}",
                      f"{name} full block N={N} C={C}",
                      f"{name} serialize 4 orders N={N}"]
        else:
            names += [f"{name} full block N={N} C={C}"]
    names += ["pool1 128->64 C=32", "unpool0 64->128 C=16"]
    names += [f"s{s} {piece} N={N} C={C}"
              for s, N, C in ((0, 128, 16), (1, 64, 32))
              for piece in ("CPE (dwconv+dense)", "MLP denses")]
    names += ["FULL PTv3 (128)"]
    _check_rows(rec, names)
    sums = rec["sums"]
    assert sums["attention_depth_weighted"] == pytest.approx(
        _weighted(rec, "attention"))
    assert sums["sum_of_parts"] == pytest.approx(
        _weighted(rec, "block") + _weighted(rec, "decoder_block"))
    assert sums["remainder"] == pytest.approx(
        sums["full"] - sums["sum_of_parts"])


def test_time_block_glue_rows():
    rec = time_block_glue.main(TINY)
    ops = ("LayerNorm", "qkv dense (C->3C)", "row gather 3C", "row gather C",
           "proj dense + residual", "mlp in+gelu+out", "residual+mask",
           "LN+qkv chained", "ALL glue chained")
    assert rec["unit"] == "us"
    _check_rows(rec, [f"N={N} C={C} {op}" for N, C in ((128, 16), (64, 32))
                      for op in ops])


def test_time_loss_parts_rows_and_parts_chain_to_the_loss(rng):
    rec = time_loss_parts.main(TINY)
    _check_rows(rec, [
        "softmax (N, C)", "errors construction ((N, C).T + abs)",
        "stable descending sort (C, N)", "fg gather (C, N)",
        "cumsums + jaccard + diff (C, N)", "gradient dot + present mean",
        "lovasz_softmax fwd", "weighted CE fwd", "lovasz fwd+bwd",
        "CELSLoss total fwd", "CELSLoss total fwd+bwd"])
    assert rec["sums"]["lovasz_parts"] == pytest.approx(
        _weighted(rec, "part"))
    assert rec["sums"]["parts_vs_whole_abs_diff"] == 0.0
    from tpu3dssf_torch.losses import lovasz_softmax
    probs = torch.softmax(t(rng.normal(size=(500, 16)).astype(np.float32)),
                          -1)
    labels0 = t(rng.integers(0, 16, 500))
    valid = t(rng.random(500) > 0.2)
    assert torch.equal(time_loss_parts.lovasz_parts(probs, labels0, valid),
                       lovasz_softmax(probs, labels0, valid))


def test_block_fwd_bwd_matches_jax_vjp(rng):
    """attr_bwd's block piece: the gradients of a PTv3Block's f32 output
    sum with respect to its parameters and input, against ``jax.grad`` of
    the JAX block (plain attention path) on the same converted weights."""
    from tpu3dssf.models import ptv3 as jptv3
    from tpu3dssf_torch.models.ptv3 import PTv3Block

    B, N, C, H, W = 2, 64, 16, 2, 32
    x = (rng.normal(size=(B, N, C)) * 0.5).astype(np.float32)
    perm = np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32)
    inv = np.argsort(perm, axis=1).astype(np.int32)
    mask = np.ones((B, N), bool)
    mask[1, -9:] = False
    jblk = jptv3.PTv3Block(C, H, W, 4.0, use_pallas=False)
    params = to_numpy_tree(jax.jit(jblk.init)(jax.random.PRNGKey(0), x, perm,
                                              inv, mask))

    def total(p, xx):
        return jnp.sum(jblk.apply(p, xx, perm, inv, mask).astype(
            jnp.float32))

    jvalue, (jgp, jgx) = jax.jit(jax.value_and_grad(total, argnums=(0, 1)))(
        params, x)

    blk = PTv3Block(C, H, W, 4.0)
    blk.load_state_dict(convert.state_dict_from_flax(params))
    value, grads = attr_bwd.block_fwd_bwd(blk, t(x), t(perm).long(),
                                          t(inv).long(), t(mask))
    np.testing.assert_allclose(value.item(), float(jvalue), **TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **TOL)
    want = convert.state_dict_from_flax(to_numpy_tree(jgp))
    names = [n for n, _ in blk.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads[:-1]):
        # a weight's gradient sums B·N = 128 products in another order:
        # held within 1e-5 of its largest entry
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def test_loss_fwd_bwd_matches_jax_exact_sort(rng):
    """attr_bwd's loss piece: CELSLoss's total (unit class weights) and its
    gradient of the logits against the JAX loss with the exact Lovász sort
    (``lovasz_softmax(..., exact_sort=True)``) and ``jax.grad``."""
    from tpu3dssf import losses as jlosses
    from tpu3dssf_torch.cli.bench_train import loss_fn

    B, P, C = 2, 300, 16
    logits = rng.normal(size=(B, P, C)).astype(np.float32)
    labels = rng.integers(0, 17, (B, P)).astype(np.int32)
    mask = rng.random((B, P)) > 0.1

    def total(lg):
        valid = (labels != 0) & mask
        labels0 = np.clip(labels - 1, 0, C - 1)
        ce = jlosses.weighted_cross_entropy(lg, labels0, valid,
                                            jnp.ones(C, jnp.float32))
        probs = jax.nn.softmax(lg, -1).reshape(-1, C)
        return ce + jlosses.lovasz_softmax(probs, labels0.reshape(-1),
                                           valid.reshape(-1),
                                           exact_sort=True)

    jvalue, jgrad = jax.value_and_grad(total)(jnp.asarray(logits))
    value, (grad,) = attr_bwd.loss_fwd_bwd(loss_fn(), t(logits), t(labels),
                                           t(mask))
    np.testing.assert_allclose(value.item(), float(jvalue), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-6,
                               rtol=1e-6)
