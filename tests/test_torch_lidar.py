"""The port's k-NN parity modes and LiDAR-only slice vs the JAX package,
and the CLIs that evaluate it.

On lattice clouds (points on a unit lattice with ±0.2 jitter, so k-NN
neighbours are never near-tied and indices agree exactly):
``knn_intensity_transfer``, ``devoxelize_nearest`` (values, indices and the
gradient in ``voxel_values``) and ``voxelize(..., "knn5")`` at atol = rtol
= 1e-5 (the same f32 operations, some sums in another order); the whole
``LidarSegmentationModel`` and a ``SegmentationPipeline`` in the parity
modes at f32, weights converted from the JAX models, at 1e-4 (f32 sums over
many layers in another order). On the CPU every k-NN call takes the plain
version, so the kernel's launch count must not move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_convert import port_pipeline_config, t, to_numpy_tree
from tests.test_torch_pipeline import _tiny_config
from tests.test_torch_serialization_voxel import _cameras
from tpu3dssf import voxel as jvox
from tpu3dssf.models import fusion as jfusion
from tpu3dssf.models import lidar_only as jlidar
from tpu3dssf.models import ptv3 as jptv3
from tpu3dssf_torch import convert, voxel
from tpu3dssf_torch.kernels import knn
from tpu3dssf_torch.models import fusion, lidar_only
from tpu3dssf_torch.train.checkpoint import save_checkpoint

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _lattice_points(rng, B=2, P=320, n=7, invalid=30):
    """(B, P, 4) points, one per cell of an n×n×(n-1) unit lattice with
    ±0.2 jitter (each its own 0.5 m voxel), random intensities; the last
    ``invalid`` rows of each sample are padding."""
    cells = np.stack(np.meshgrid(np.arange(n), np.arange(n),
                                 np.arange(n - 1), indexing="ij"),
                     -1).reshape(-1, 3)
    pts = np.zeros((B, P, 4), np.float32)
    mask = np.zeros((B, P), bool)
    m = min(len(cells), P - invalid)
    for b in range(B):
        c = cells[rng.permutation(len(cells))[:m]] - n // 2
        pts[b, :m, :3] = c + rng.uniform(-0.2, 0.2, size=(m, 3))
        pts[b, :m, 3] = rng.random(m)
        mask[b, :m] = True
    pts[:, m:, :3] = rng.normal(size=(B, P - m, 3)) * 5   # garbage
    return pts, mask


def _jax_voxelize(pts, mask, size, cap, mode):
    return jax.vmap(lambda p, m: jvox.voxelize(p, m, size, cap, mode))(
        jnp.asarray(pts), jnp.asarray(mask))


def test_knn_intensity_transfer_matches(rng):
    pts, mask = _lattice_points(rng)
    vox = _jax_voxelize(pts, mask, 0.5, 512, "mean")
    cents = np.asarray(vox.voxel_raw[..., :3])
    vmask = np.asarray(vox.voxel_mask)
    want = jax.vmap(jvox.knn_intensity_transfer)(
        jnp.asarray(cents), jnp.asarray(vmask), jnp.asarray(pts[..., :3]),
        jnp.asarray(pts[..., 3]), jnp.asarray(mask))
    before = knn.LAUNCHES
    got = voxel.knn_intensity_transfer(t(cents), t(vmask),
                                       t(pts[..., :3].copy()),
                                       t(pts[..., 3].copy()), t(mask))
    assert knn.LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got.abs().max()) > 0.1


def test_devoxelize_nearest_matches_with_its_gradient(rng):
    pts, mask = _lattice_points(rng)
    vox = _jax_voxelize(pts, mask, 0.5, 512, "mean")
    # centroids of every second live voxel: most points' nearest centroid
    # is another point's
    vmask = np.asarray(vox.voxel_mask).copy()
    vmask[:, ::2] = False
    cents = np.asarray(vox.voxel_raw[..., :3])
    vals = rng.normal(size=(2, 512, 5)).astype(np.float32)
    args = (pts[..., :3].copy(), mask, cents, vmask)

    def jloss(v):
        out, _ = jax.vmap(jvox.devoxelize_nearest)(
            *(jnp.asarray(a) for a in args), v)
        return jnp.sum(out ** 2), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(vals))
    _, want_idx = jax.vmap(jvox.devoxelize_nearest)(
        *(jnp.asarray(a) for a in args), jnp.asarray(vals))
    v = t(vals).requires_grad_()
    got, idx = voxel.devoxelize_nearest(*(t(a) for a in args), v)
    (got ** 2).sum().backward()
    _eq(idx, want_idx)
    assert idx.dtype == torch.int32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgrad), **TOL)
    assert float(v.grad.abs().sum()) > 0


def test_voxelize_knn5_matches_every_field(rng):
    pts, mask = _lattice_points(rng)
    # three points in a voxel, none equidistant from their centroid (a
    # voxel of two is a tie: its centroid is their midpoint)
    pts[:, :20, :3] = np.round(pts[:, :20, :3]) + rng.uniform(
        0.05, 0.2, size=(2, 20, 3))
    pts[:, 40:60, :3] = pts[:, :20, :3] + np.float32([0.02, 0.01, 0.0])
    pts[:, 60:80, :3] = pts[:, :20, :3] + np.float32([0.05, -0.03, 0.04])
    got = voxel.voxelize(t(pts), t(mask), 0.5, 512, "knn5")
    want = _jax_voxelize(pts, mask, 0.5, 512, "knn5")
    for name in ("voxel_coords", "voxel_mask", "num_voxels", "point_voxel",
                 "point_ok"):
        _eq(getattr(got, name), getattr(want, name))
    np.testing.assert_allclose(got.voxel_raw.numpy(),
                               np.asarray(want.voxel_raw), **TOL)
    mean = voxel.voxelize(t(pts), t(mask), 0.5, 512, "mean")
    assert not torch.allclose(mean.voxel_raw[..., 3], got.voxel_raw[..., 3])


def _small_ptv3():
    return jptv3.PTv3Config(
        enc_depths=(1, 1), enc_channels=(16, 32), enc_heads=(1, 2),
        enc_window=(128, 128), dec_depths=(1,), dec_channels=(16,),
        dec_heads=(1,), dec_window=(128,), use_pallas=False)


def test_lidar_model_matches_jax_in_the_parity_modes(rng):
    pcfg = jfusion.PipelineConfig(
        fusion=jfusion.FusionConfig(output_dim=16), ptv3=_small_ptv3(),
        voxel_size=0.5, voxel_capacity=512, intensity_mode="knn5",
        devoxelize_mode="nearest")
    pts, mask = _lattice_points(rng)
    jmodel = jlidar.LidarSegmentationModel(pcfg)
    jargs = (jnp.asarray(pts), jnp.asarray(mask))
    params = to_numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                                *jargs))
    assert set(params["params"]) == {"ptv3", "head"}
    want = jax.jit(jmodel.apply)(params, *jargs)

    model = lidar_only.LidarSegmentationModel(port_pipeline_config(pcfg))
    model.load_state_dict(convert.pipeline_state_dict_from_flax(params))
    before = knn.LAUNCHES
    with torch.no_grad():
        got = model(t(pts), t(mask))
    assert knn.LAUNCHES == before
    assert got.shape == (2, 320, 16)
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_fusion_pipeline_matches_jax_in_the_parity_modes(rng):
    pcfg = jfusion.PipelineConfig(
        fusion=jfusion.FusionConfig(point_feat_dim=16, patch_tok_dim=32,
                                    hidden_dims=(32, 16), output_dim=16,
                                    patch_size=8, encoder_size=(24, 40)),
        ptv3=_small_ptv3(), voxel_size=0.5, voxel_capacity=512,
        intensity_mode="knn5", devoxelize_mode="nearest")
    pts, mask = _lattice_points(rng)
    tokens = rng.normal(size=(2, 6, 15, 32)).astype(np.float32)
    K, Rt = _cameras(rng)
    args = (pts, mask, tokens, K, Rt)
    jargs = [jnp.asarray(a) for a in args]
    jpipe = jfusion.SegmentationPipeline(pcfg)
    params = to_numpy_tree(jax.jit(jpipe.init)(jax.random.PRNGKey(4),
                                               *jargs))
    want = jax.jit(jpipe.apply)(params, *jargs)
    model = fusion.SegmentationPipeline(port_pipeline_config(pcfg))
    model.load_state_dict(convert.pipeline_state_dict_from_flax(params))
    with torch.no_grad():
        got = model(*(t(a) for a in args))
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def _tiny_lidar_config(tmp_path):
    """The pipeline tests' tiny config as a LiDAR-only parity model."""
    path = _tiny_config(tmp_path)
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw["train_params"]["image_encoder"] = "none"
    raw["tpu_params"].update(intensity_mode="knn5", devoxelize_mode="nearest")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


CLIS = ("main_infer", "main_test", "main_sample")


@pytest.mark.parametrize("cli", CLIS)
def test_cli_runs_the_lidar_parity_model_on_cpu(tmp_path, capsys, cli):
    import importlib

    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.kernels.modules import flash_attention as fa

    path = _tiny_lidar_config(tmp_path)
    ckpt = tmp_path / "ckpt"
    if cli == "main_test":     # a checkpoint to restore, not the random init
        cfg = common.load_config(path)
        model, _ = common.build_pipeline(cfg, None, "cpu", seed=9)
        save_checkpoint(str(ckpt), 4, common.init_state(cfg, model))
    before = (knn.LAUNCHES, fa.LAUNCHES)
    main = importlib.import_module(f"tpu3dssf_torch.cli.{cli}").main
    out = main(["--config", path, "--device", "cpu"])
    assert (knn.LAUNCHES, fa.LAUNCHES) == before  # the plain versions only
    for k in ("loss", "overall_acc", "mean_iou", "f1"):
        assert np.isfinite(out[k])
    text = capsys.readouterr().out
    assert "EVALUATION METRICS" in text
    if cli == "main_test":
        assert f"Loaded checkpoint from {ckpt} (step 4)" in text
        assert (ckpt / "per_class_iou.png").exists()
    if cli == "main_sample":
        assert "no checkpoint" in text and "random init" in text
        assert (ckpt / "segmentation_result.html").exists()


@pytest.mark.parametrize("cli", CLIS)
def test_cli_refuses_to_fall_back_to_cpu(tmp_path, cli):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would use it")
    main = importlib.import_module(f"tpu3dssf_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", _tiny_lidar_config(tmp_path)])
