"""The port's data, tensor and sequence parallelism (``tpu3dssf_torch.
parallel``) against the JAX package's, on the CPU.

One module fixture starts two gloo ranks once (tests/torch_parallel_ranks.py,
processes that import neither JAX nor ``tpu3dssf``) and runs every
multi-rank case in them; the JAX references run here meanwhile, on a
2-device sub-mesh of the 8 virtual CPU devices, without Pallas
(``use_pallas=False`` models, the einsum ViT): Pallas interpret mode on a
multi-device mesh can deadlock in-process (tests/test_parallel.py says why).

Tolerances: the data-parallel eval's integer sums exact and its loss 1e-5
relative; the data-parallel train step, alone and with ``grad_accum=2``,
against JAX's mesh step: loss 1e-5 relative, every parameter within 1e-5
(as tests/test_train.py holds JAX's mesh step to its one-device step); the
tensor-parallel ViT against JAX's tensor-parallel and unsharded forward
within 1e-5, its input gradient against the port's unsharded one within
1e-5, each rank's shard bit for bit against JAX's ``prepare_tp_params``
output converted and sliced; the sequence-parallel CPE within 1e-6 and
block and its input gradient within 1e-5 of JAX's ``sp_block_apply``.
"""

import dataclasses
import functools
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from jax.sharding import Mesh as JaxMesh

from tests.test_torch_convert import port_config, port_pipeline_config, t
from tests.test_torch_convert import to_numpy_tree
from tests.test_torch_lidar import _tiny_lidar_config
from tpu3dssf import losses as jlosses
from tpu3dssf import parallel as jpar
from tpu3dssf.models import fusion as jfusion
from tpu3dssf.models import lidar_only as jlidar
from tpu3dssf.models import ptv3 as jptv3
from tpu3dssf.models import vit as jvit
from tpu3dssf.train import loop as jloop
from tpu3dssf.train import state as jstate
from tpu3dssf_torch import convert
from tpu3dssf_torch.cli.main_infer import pad_to
from tpu3dssf_torch.losses import CELSLoss
from tpu3dssf_torch.models import lidar_only, vit
from tpu3dssf_torch.models.ptv3 import PTv3Block
from tpu3dssf_torch.parallel import Mesh, shard_batch, sp_block_apply
from tpu3dssf_torch.parallel.mesh import shard_rows
from tpu3dssf_torch.train.loop import make_eval_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT_KW = dict(name="AdamW", learning_rate=1e-3, weight_decay=1e-3,
              lr_scheduler="CosineAnnealingLR", steps_per_epoch=24,
              num_epochs=20, grad_clip=1.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lidar_pipeline_config():
    """tests/test_train.py's tiny LiDAR-only model."""
    return jfusion.PipelineConfig(
        fusion=jfusion.FusionConfig(),
        ptv3=jptv3.PTv3Config(orders=("z",), enc_depths=(1, 1),
                              enc_channels=(8, 8), enc_heads=(1, 1),
                              enc_window=(16, 16), dec_depths=(1,),
                              dec_channels=(8,), dec_heads=(1,),
                              dec_window=(16,), use_pallas=False),
        voxel_size=0.5, voxel_capacity=64)


def _lidar_batch(rng, B, P=128):
    return {
        "points": np.concatenate([rng.normal(size=(B, P, 3)) * 5,
                                  rng.random((B, P, 1))], -1).astype(
                                      np.float32),
        "point_valid": rng.random((B, P)) > 0.1,
        "labels": rng.integers(0, 17, size=(B, P)).astype(np.int32),
        "mask": rng.random((B, P)) > 0.2,
        "cam_intrinsics": np.zeros((B, 6, 3, 3), np.float32),
        "lidar2cam": np.zeros((B, 6, 4, 4), np.float32),
    }


def _vit_config(**kw):
    """tests/test_parallel.py's tensor-parallel ViT."""
    return jvit.ViTConfig(patch_size=16, image_size=(32, 48), hidden_size=32,
                          num_layers=2, num_heads=4, num_register_tokens=4,
                          use_rope=True, **kw)


def _sp_data(rng, B=2, N=512, C=32):
    """tests/test_sp.py's features and mask."""
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[0, 400:] = False
    mask[1, 200:230] = False
    return x, mask


def _sp_block(sp=None):
    return jptv3.PTv3Block(channels=32, heads=2, window=16, mlp_ratio=2.0,
                           use_pallas=False, sp_axis=sp)


def _sub_mesh(axis):
    return JaxMesh(np.array(jax.devices()[:2]), (axis,))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs(rng, tmp):
    """Seeded inputs and JAX weights converted to the port, for the ranks;
    the JAX trees stay here for the references."""
    pcfg = _lidar_pipeline_config()
    jmodel = jlidar.LidarSegmentationModel(pcfg)
    batch4 = _lidar_batch(rng, 4)
    batch3 = _lidar_batch(rng, 3)
    jb = {k: jnp.asarray(v) for k, v in batch4.items()}
    lidar_params = to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jb["points"], jb["point_valid"]))

    vcfg = _vit_config()
    images = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
    vit_params = to_numpy_tree(jax.jit(jvit.VisionTransformer(vcfg).init)(
        jax.random.PRNGKey(0), images))
    # O(1) LayerScale gammas, so that the blocks matter
    for i in range(vcfg.num_layers):
        for ls in ("ls1", "ls2"):
            g = vit_params["params"][f"block{i}"][ls]
            g["gamma"] = rng.normal(size=g["gamma"].shape).astype(np.float32)
    rcfg = jvit.ViTConfig(patch_size=16, image_size=(32, 32),
                          hidden_size=256, num_layers=1, num_heads=16,
                          use_rope=False, packed_head_groups=False)
    route_images = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
    route_params = jax.jit(jvit.VisionTransformer(rcfg).init)(
        jax.random.PRNGKey(1), route_images)

    x, mask = _sp_data(rng)
    cpe_params = jax.jit(jptv3.SerializedCPE(channels=32).init)(
        jax.random.key(0), x, None, None, mask)
    block_params = jax.jit(_sp_block().init)(jax.random.key(1), x, None,
                                             None, mask)

    mesh_cfg = _tiny_lidar_config(pathlib.Path(tmp))
    raw = yaml.safe_load(open(mesh_cfg))
    raw["tpu_params"].update(mesh_shape=[2], synthetic_samples=12)
    one_cfg = os.path.join(tmp, "one.yaml")
    yaml.safe_dump(raw | {"tpu_params": dict(raw["tpu_params"],
                                             mesh_shape=[1])},
                   open(one_cfg, "w"))
    yaml.safe_dump(raw, open(mesh_cfg, "w"))

    port = dict(
        lidar_cfg=port_pipeline_config(pcfg),
        lidar_state=convert.pipeline_state_dict_from_flax(lidar_params),
        opt_kw=OPT_KW, eval_batches=[batch4, batch3], train_batch=batch4,
        vit_cfg=port_config(vcfg, vit.ViTConfig),
        vit_state=convert.vit_state_dict_from_flax(vit_params, vcfg),
        vit_images=images,
        vit_proj=rng.normal(size=(2, 6, 32)).astype(np.float32),
        route_cfg=port_config(rcfg, vit.ViTConfig),
        route_state=convert.vit_state_dict_from_flax(
            to_numpy_tree(route_params), rcfg),
        route_images=route_images,
        sp_x=x, sp_mask=mask,
        sp_cpe_state=convert.state_dict_from_flax(to_numpy_tree(cpe_params)),
        sp_block_state=convert.state_dict_from_flax(
            to_numpy_tree(block_params)),
        mesh_config=mesh_cfg)
    torch.save(port, os.path.join(tmp, "inputs.pt"))
    jax_side = dict(pcfg=pcfg, jmodel=jmodel, lidar_params=lidar_params,
                    vcfg=vcfg, vit_params=vit_params, cpe_params=cpe_params,
                    block_params=block_params, one_config=one_cfg)
    return port, jax_side


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the two ranks, then compute what the tests compare them with
    while they run: (the port's inputs, the JAX trees, [rank 0's results,
    rank 1's])."""
    tmp = str(tmp_path_factory.mktemp("ranks"))
    port, jax_side = _inputs(np.random.default_rng(0), tmp)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_ranks", tmp], cwd=ROOT,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    jax_side["refs"] = _jax_references(port, jax_side)
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-6000:]}"
    results = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(2)]
    return port, jax_side, results


def _jax_references(port, j):
    """Everything the tests hold the ranks to, from the JAX package. Its
    Lovász sort runs exact, as the port's does (JAX's default quantises
    the sort key; tests/test_torch_train.py does the same)."""
    exact = functools.partial(jlosses.lovasz_softmax, exact_sort=True)
    default, jlosses.lovasz_softmax = jlosses.lovasz_softmax, exact
    try:
        return _references(port, j)
    finally:
        jlosses.lovasz_softmax = default


def _references(port, j):
    refs = {}
    loss = jlosses.CELSLoss(weight=np.ones(16, np.float32))
    eval_step = jloop.make_eval_step(loss, 16)
    state = jstate.create_train_state(j["jmodel"], j["lidar_params"],
                                      optax.identity())
    sums = None
    for b in port["eval_batches"]:   # the partial batch padded, as JAX's CLI
        b = pad_to(b, 4)
        m = eval_step(state, {k: jnp.asarray(v) for k, v in b.items()},
                      jnp.zeros((4, 1, 1, 1)))
        m = {k: np.asarray(v, np.float64) for k, v in m.items()}
        sums = m if sums is None else {k: sums[k] + m[k] for k in m}
    refs["eval"] = sums

    # JAX's mesh train step on a 2-device sub-mesh (create_mesh((2,)) would
    # refuse the 8 virtual devices)
    mesh = _sub_mesh("data")
    for ga in (1, 2):
        kw = dict(OPT_KW)
        st = jstate.create_train_state(
            j["jmodel"], j["lidar_params"],
            jstate.create_optimizer(kw.pop("name"), **kw))
        st = jpar.replicate(st, mesh)
        batch = jpar.shard_batch(port["train_batch"], mesh)
        tokens = jax.device_put(np.zeros((4, 1, 1, 1), np.float32),
                                jax.sharding.NamedSharding(
                                    mesh, jax.sharding.PartitionSpec("data")))
        step = jloop.make_train_step(loss, grad_accum=ga)
        with mesh:
            st, m = step(st, batch, tokens)
        refs[f"train{ga}"] = dict(
            loss=float(m["loss"]), correct=int(m["correct"]),
            valid=int(m["valid"]),
            params=convert.pipeline_state_dict_from_flax(
                to_numpy_tree(st.params)))

    # the einsum ViT: unsharded, and under vit_tp_shardings on a model axis
    vcfg, params = j["vcfg"], j["vit_params"]
    model = jvit.VisionTransformer(vcfg)
    images = jnp.asarray(port["vit_images"])
    refs["vit"] = np.asarray(jax.jit(model.apply)(
        params, images)["patch_features"])
    mesh = _sub_mesh("model")
    sharded = jax.device_put(params, jpar.vit_tp_shardings(params, mesh))
    with mesh:
        refs["vit_tp"] = np.asarray(jax.jit(model.apply)(
            sharded, images)["patch_features"])
    tp_params, _ = jvit.prepare_tp_params(
        params, dataclasses.replace(vcfg, use_flash=True), mesh)
    refs["vit_tp_state"] = convert.vit_state_dict_from_flax(
        to_numpy_tree(tp_params), vcfg)

    # sequence parallelism: JAX's own SP paths on a 2-device seq axis
    mesh = _sub_mesh("seq")
    P = jax.sharding.PartitionSpec
    x, mask = jnp.asarray(port["sp_x"]), jnp.asarray(port["sp_mask"])
    cpe_sp = jptv3.SerializedCPE(channels=32, sp_axis="seq")
    refs["cpe"] = np.asarray(jax.jit(jax.shard_map(
        lambda p, xs, ms: cpe_sp.apply(p, xs, None, None, ms),
        mesh=mesh, in_specs=(P(), P(None, "seq", None), P(None, "seq")),
        out_specs=P(None, "seq", None), check_vma=False))(
            j["cpe_params"], x, mask))
    blk, bp = _sp_block("seq"), j["block_params"]

    @jax.jit
    def block_and_grad(xx):
        out, vjp = jax.vjp(lambda v: jpar.sp_block_apply(
            blk, bp, v, mask, mesh, axis="seq"), xx)
        return out, vjp(jnp.ones_like(out))[0]

    refs["block"], refs["block_grad"] = map(np.asarray, block_and_grad(x))
    return refs


def _halves(results, key, axis=1):
    return np.concatenate([r[key] for r in results], axis=axis)


def test_create_mesh_maps_ranks_and_refuses_a_wrong_shape(ranks):
    _, _, results = ranks
    assert [r["coords"] for r in results] == [0, 1]
    assert all(r["owns_group"] for r in results)
    for r in results:
        assert r["shape_error"].startswith(
            "Number of devices 2 must equal the product of mesh_shape (4,)")
        assert r["modules"] == []         # no JAX, no tpu3dssf


def test_shard_batch_takes_contiguous_rows_of_each_microbatch():
    x = np.arange(8)
    mesh = [Mesh(("data",), (2,), (r,)) for r in range(2)]
    assert [shard_rows(x, m).tolist() for m in mesh] == [[0, 1, 2, 3],
                                                         [4, 5, 6, 7]]
    assert [shard_rows(x, m, microbatches=2).tolist() for m in mesh] == [
        [0, 1, 4, 5], [2, 3, 6, 7]]
    b = shard_batch({"a": torch.arange(6).reshape(6, 1), "s": np.float32(1)},
                    mesh[1])
    assert b["a"].flatten().tolist() == [3, 4, 5] and b["s"] == 1
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch({"a": np.zeros(5)}, mesh[0])
    with pytest.raises(ValueError, match="microbatches"):
        shard_rows(np.zeros(6), mesh[0], microbatches=2)


def test_replicate_gives_every_rank_rank0s_bits(ranks):
    port, _, results = ranks
    want = port["lidar_state"]
    for r in results:
        assert set(r["replicated"]) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(r["replicated"][k], w.numpy(),
                                          err_msg=k)


def test_data_parallel_eval_sums_match_jax(ranks):
    """Two batches (one of 3 scenes, padded to 4 by ``pad_to``) over two
    ranks: the summed counts equal JAX's one-device eval of the unpadded
    batches exactly, the loss sum within 1e-5."""
    _, j, results = ranks
    want = j["refs"]["eval"]
    local = [r["eval_local"] for r in results]
    for r in results:
        s = r["eval_sums"]
        np.testing.assert_array_equal(s["confusion"], want["confusion"])
        assert s["correct"] == want["correct"] and s["valid"] == want["valid"]
        np.testing.assert_allclose(s["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_array_equal(
            s["confusion"], local[0]["confusion"] + local[1]["confusion"])
    assert local[0]["valid"] > 0 and local[1]["valid"] > 0
    assert local[0]["loss"] == local[1]["loss"]   # the whole batch's, alike


@pytest.mark.parametrize("ga", [1, 2])
def test_data_parallel_train_step_matches_jax_mesh_step(ranks, ga):
    _, j, results = ranks
    want = j["refs"][f"train{ga}"]
    for r in results:
        got = r[f"train{ga}"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert (got["correct"], got["valid"]) == (want["correct"],
                                                  want["valid"])
        assert got["step"] == 1
        assert set(got["params"]) == set(want["params"])
        for k, w in want["params"].items():
            g, w = got["params"][k], w.numpy()
            if k.endswith("attn.qkv.bias"):
                # the key bias adds q·b_k to every score of a query row,
                # which softmax ignores: its gradient is 0 in exact
                # arithmetic and rounding noise in both frameworks, which
                # Adam's first step turns into an O(lr) update of either
                # sign (tests/test_torch_train.py leaves it out likewise)
                C = g.shape[0] // 3
                g, w = (np.delete(x, np.s_[C:2 * C]) for x in (g, w))
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("ga", [1, 2])
def test_data_parallel_train_step_with_drop_path_is_the_one_process_step(
        ranks, ga):
    """DropPath at 0.5: every rank draws the whole microbatch's masks from
    the one seeded generator and keeps its rows, so the 2-rank step equals
    the one-process step on the whole batch (loss 1e-5 relative, every
    parameter within 1e-5, the key third of the qkv biases left out as in
    the JAX comparison above); and DropPath dropped something (the loss
    differs from the step without it)."""
    _, _, results = ranks
    for r in results:
        got, want = (r[f"train_drop_path{ga}"][k] for k in ("mesh", "one"))
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["loss"] != r[f"train{ga}"]["loss"]
        assert set(got["params"]) == set(want["params"])
        for k, w in want["params"].items():
            g = got["params"][k]
            if k.endswith("attn.qkv.bias"):
                C = g.shape[0] // 3
                g, w = (np.delete(x, np.s_[C:2 * C]) for x in (g, w))
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=k)


def test_tensor_parallel_vit_matches_jax(ranks):
    """Each rank's TP forward (C = 32, H = 4, RoPE, 2 layers) against JAX's
    tensor-parallel and unsharded einsum forward, and its input gradient
    against the port's unsharded one."""
    _, j, results = ranks
    for r in results:
        np.testing.assert_allclose(r["tp_features"], j["refs"]["vit_tp"],
                                   atol=1e-5)
        np.testing.assert_allclose(r["tp_features"], j["refs"]["vit"],
                                   atol=1e-5)
        np.testing.assert_allclose(r["tp_unsharded"], j["refs"]["vit"],
                                   atol=1e-5)
        np.testing.assert_allclose(r["tp_grad"], r["tp_grad_unsharded"],
                                   atol=1e-5)
        assert np.abs(r["tp_grad"]).max() > 1e-3


def test_tensor_parallel_shards_are_slices_of_jax_prepare_tp_params(ranks):
    """Bit for bit: each rank's qkv and mlp_in rows, proj and mlp_out
    columns, and every whole parameter, against JAX's permuted tree."""
    _, j, results = ranks
    full = j["refs"]["vit_tp_state"]
    for rank, r in enumerate(results):
        assert set(r["tp_state"]) == set(full)
        for k, w in full.items():
            w = w.numpy()
            mod, leaf = (["", ""] + k.split("."))[-2:]
            if mod in ("qkv", "mlp_in"):
                n = w.shape[0] // 2
                w = w[rank * n:(rank + 1) * n]
            elif mod in ("proj", "mlp_out") and leaf == "weight":
                n = w.shape[1] // 2
                w = w[:, rank * n:(rank + 1) * n]
            np.testing.assert_array_equal(r["tp_state"][k], w, err_msg=k)


def test_tensor_parallel_w8a8_vit_is_the_one_process_one(ranks):
    """W8A8 at TP = 2: the row-parallel layers quantize by the whole row's
    max and sum their int32 partial products, so each rank's patch
    features equal the one-process W8A8 ViT's (within 1e-5 of its largest
    value), which differ from the float ViT's."""
    _, _, results = ranks
    want = results[0]["tp_w8a8_unsharded"]
    for r in results:
        np.testing.assert_array_equal(r["tp_w8a8_unsharded"], want)
        assert r["tp_w8a8"].shape == want.shape
        assert np.abs(r["tp_w8a8"] - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(want - results[0]["tp_unsharded"]).max() > 0


def test_tensor_parallel_routes_by_the_local_heads(ranks):
    """16 heads of D = 16 with ``packed_head_groups=False``: unsharded the
    (B, N, H, D) route (K8's), at TP = 2 each rank's 8 heads on the packed
    route (K1's) with a contiguous qkv; the same tokens."""
    _, _, results = ranks
    for r in results:
        assert r["tp_route"]["calls"] == [("bhnd", 16, True),
                                          ("packed", 8, True)]
        assert r["tp_route"]["max_diff"] < 1e-5


def test_sequence_parallel_cpe_matches_jax(ranks):
    _, j, results = ranks
    np.testing.assert_allclose(_halves(results, "sp_cpe"), j["refs"]["cpe"],
                               atol=1e-6)


def test_sequence_parallel_block_matches_jax(ranks):
    _, j, results = ranks
    np.testing.assert_allclose(_halves(results, "sp_block"),
                               j["refs"]["block"], atol=1e-5)


def test_sequence_parallel_block_gradient_matches_jax(ranks):
    """The input gradient of Σ over ranks of each rank's summed span: the
    halo exchange's backward carries the neighbours' share."""
    _, j, results = ranks
    got = results[0]["sp_grad"] + results[1]["sp_grad"]
    np.testing.assert_allclose(got, j["refs"]["block_grad"], atol=1e-5)
    assert np.abs(results[0]["sp_grad"][:, 256:]).max() == 0.0


def test_sequence_parallel_rejects_bad_shapes_and_orders(rng):
    mesh = Mesh(("seq",), (2,), (0,))
    blk = PTv3Block(32, 2, 16, 2.0, sp_axis="seq")
    x = torch.zeros(2, 520, 32)
    mask = torch.ones(2, 520, dtype=torch.bool)
    with pytest.raises(ValueError, match="multiple of shards"):
        sp_block_apply(blk, x, mask, mesh, axis="seq")
    with pytest.raises(ValueError, match="must equal the mesh axis"):
        sp_block_apply(PTv3Block(32, 2, 16, 2.0), x, mask, mesh, axis="seq")
    perm = torch.arange(256).repeat(2, 1)
    with pytest.raises(ValueError, match="CPE order"):
        blk(x[:, :256], perm, perm, mask[:, :256])
    with pytest.raises(ValueError, match="CPE order itself"):
        blk.cpe(x[:, :256], perm, perm, mask[:, :256])


def test_qkv_tp_permutation_refuses_heads_that_do_not_divide():
    with pytest.raises(ValueError, match="not divisible by shards"):
        vit.qkv_tp_permutation(32, 6, 4)
    with pytest.raises(ValueError, match="not divisible by shards"):
        jvit.qkv_tp_permutation(32, 6, 4)


def test_pad_to_rows_change_no_metric(rng):
    """A batch of 3 padded to 4 by ``pad_to`` (masked duplicates of its last
    row) gives the eval step's every metric of the batch of 3."""
    pcfg = _lidar_pipeline_config()
    model = lidar_only.LidarSegmentationModel(port_pipeline_config(pcfg))
    from tpu3dssf_torch.models.layers import init_weights
    init_weights(model, 0)
    step = make_eval_step(CELSLoss(weight=np.ones(16, np.float32)), 16)
    b3 = _lidar_batch(rng, 3)
    b4 = pad_to(b3, 4)
    assert b4["points"].shape[0] == 4 and not b4["mask"][3].any()
    assert not b4["point_valid"][3].any()
    want, got = (step(model, {k: t(v) for k, v in b.items()},
                      torch.zeros(len(b["points"]), 1, 1, 1))
                 for b in (b3, b4))
    for k in ("correct", "valid", "confusion"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    for k in ("loss", "ce", "lovasz"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6)
    assert pad_to(b4, 4) is b4


def test_main_infer_on_a_mesh_matches_one_device(ranks, capsys):
    """``main_infer`` with ``mesh_shape: [2]`` on two ranks (3 test scenes
    at batch 2: the last batch padded) against the one-process run."""
    from tpu3dssf_torch.cli.main_infer import main
    _, j, results = ranks
    want = main(["--config", j["one_config"], "--device", "cpu"])
    one = capsys.readouterr().out
    for r in results:
        got = r["infer_metrics"]
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    lead = results[0]["infer_stdout"]
    assert "EVALUATION METRICS" in lead and "over 2 ranks" in lead
    assert results[1]["infer_stdout"] == ""

    def streamed(text):   # "streamed 2 batches, 3,000 valid points"
        line = next(x for x in text.splitlines() if "streamed" in x)
        return line.split(" in ")[0]

    assert streamed(lead) == streamed(one)
    assert streamed(one).startswith("streamed 2 batches")


def test_main_train_ignores_the_mesh_as_jax_does(tmp_path, capsys):
    from tpu3dssf_torch.cli.main_train import main
    path = _tiny_lidar_config(tmp_path)
    raw = yaml.safe_load(open(path))
    raw["tpu_params"].update(mesh_shape=[2], synthetic_samples=4)
    yaml.safe_dump(raw, open(path, "w"))
    state, tr, val = main(["--config", path, "--device", "cpu"])
    assert len(tr) == len(val) == 1 and state.step == 2
    assert ("mesh_shape [2] is ignored: main_train trains on one device"
            in capsys.readouterr().out)


def test_mesh_needs_its_ranks():
    from tpu3dssf_torch.parallel import create_mesh
    import torch.distributed as dist
    if dist.is_initialized() or "RANK" in os.environ:
        pytest.skip("a process group or rank environment is present")
    with pytest.raises(RuntimeError, match="torchrun"):
        create_mesh((2,), device="cpu")
