"""The port's fused slice vs the JAX package's, and the port's CLI.

Images → preprocess → a small ViT → patch tokens → SegmentationPipeline
(voxelize → small PTv3 → fusion head → devoxelize) → CELSLoss and the
confusion matrix, on weights converted from the JAX models. Tolerances:
per-module f32 outputs at atol = rtol = 1e-5; the whole slice (logits)
at 1e-4 (f32 sums over many layers in another order); Lovász against
JAX's exact sort at 1e-6 and against its default 13-bit-keyed sort at
1e-5 (losses.py bounds that difference near 1e-7); integer outputs
(predictions, confusion counts) exactly.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_convert import (port_config, port_pipeline_config, t,
                                      to_numpy_tree)
from tests.test_torch_serialization_voxel import _cameras
from tpu3dssf import losses as jlosses
from tpu3dssf import metrics as jmetrics
from tpu3dssf.models import fusion as jfusion
from tpu3dssf.models import ptv3 as jptv3
from tpu3dssf.models import vit as jvit
from tpu3dssf.train import loop as jloop
from tpu3dssf_torch import convert, losses, metrics
from tpu3dssf_torch.models import fusion, vit
from tpu3dssf_torch.train import loop

TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fusion_cfg():
    return jfusion.FusionConfig(point_feat_dim=16, patch_tok_dim=32,
                                hidden_dims=(32, 16), output_dim=16,
                                patch_size=8, encoder_size=(24, 40))


def _tokens_and_voxels(rng, B=2, V=96):
    tokens = rng.normal(size=(B, 6, 15, 32)).astype(np.float32)
    xyz = (rng.normal(size=(B, V, 3)) * 8).astype(np.float32)
    K, Rt = _cameras(rng, B)
    return tokens, xyz, K, Rt


def test_gather_camera_features_matches(rng):
    cfg = _fusion_cfg()
    tokens, xyz, K, Rt = _tokens_and_voxels(rng)
    want, jvalid = jfusion.gather_camera_features(
        jnp.asarray(tokens), jnp.asarray(xyz), jnp.asarray(K),
        jnp.asarray(Rt), cfg)
    got, valid = fusion.gather_camera_features(
        t(tokens), t(xyz), t(K), t(Rt), port_config(cfg,
                                                    fusion.FusionConfig))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.any(1).float().mean() > 0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fusion_head_matches(rng):
    cfg = _fusion_cfg()
    tokens, xyz, K, Rt = _tokens_and_voxels(rng)
    feats = rng.normal(size=(2, 96, 16)).astype(np.float32)
    raw = np.concatenate([xyz, rng.random((2, 96, 1))], -1).astype(
        np.float32)
    vmask = rng.random((2, 96)) > 0.2
    args = (tokens, feats, raw, vmask, K, Rt)
    jargs = [jnp.asarray(a) for a in args]
    jmodel = jfusion.FeatureFusionModel(cfg)
    params = to_numpy_tree(jmodel.init(jax.random.PRNGKey(0), *jargs))
    model = fusion.FeatureFusionModel(port_config(cfg, fusion.FusionConfig))
    model.load_state_dict(convert.state_dict_from_flax(params))
    with torch.no_grad():
        got = model(*(t(a) for a in args))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmodel.apply(params, *jargs)),
                               **TOL)


def _slice_inputs(rng, B=2, P=400):
    xyz = (rng.normal(size=(B, P, 3)) * 6).astype(np.float32)
    points = np.concatenate([xyz, rng.random((B, P, 1))], -1).astype(
        np.float32)
    point_valid = np.ones((B, P), bool)
    point_valid[1, -60:] = False
    labels = rng.integers(0, 17, size=(B, P)).astype(np.int32)
    mask = point_valid & (labels != 0)
    images = rng.integers(0, 256, size=(B, 6, 18, 32, 3)).astype(np.uint8)
    K, Rt = _cameras(rng, B)
    return dict(points=points, point_valid=point_valid, labels=labels,
                mask=mask, cam_intrinsics=K, lidar2cam=Rt), images


def test_fused_slice_matches_jax(rng):
    """images → ViT tokens → pipeline logits → loss + confusion."""
    vcfg = jvit.ViTConfig(patch_size=8, image_size=(24, 40), hidden_size=32,
                          num_layers=2, num_heads=2, num_register_tokens=4,
                          use_rope=True, ln_eps=1e-5, scan_layers=True)
    pcfg = jfusion.PipelineConfig(
        fusion=_fusion_cfg(),
        ptv3=jptv3.PTv3Config(
            enc_depths=(1, 2), enc_channels=(16, 32), enc_heads=(1, 2),
            enc_window=(32, 32), dec_depths=(2,), dec_channels=(16,),
            dec_heads=(1,), dec_window=(32,), use_pallas=False),
        voxel_size=0.5, voxel_capacity=128)
    batch, images = _slice_inputs(rng)

    jvit_model = jvit.VisionTransformer(vcfg)
    vparams = to_numpy_tree(jvit_model.init(jax.random.PRNGKey(1),
                                            jnp.zeros((1, 24, 40, 3))))
    vparams, fcfg = jvit.fold_layerscale(vparams, vcfg)
    vparams = to_numpy_tree(vparams)
    jencode = jloop.make_image_encode_fn(jvit.VisionTransformer(fcfg),
                                         vparams, (24, 40))
    jtokens = jencode(jnp.asarray(images))
    jpipe = jfusion.SegmentationPipeline(pcfg)
    jargs = [jnp.asarray(batch[k]) for k in ("points", "point_valid")]
    jargs += [jtokens] + [jnp.asarray(batch[k])
                          for k in ("cam_intrinsics", "lidar2cam")]
    params = to_numpy_tree(jax.jit(jpipe.init)(jax.random.PRNGKey(2),
                                               *jargs))
    want = jax.jit(jpipe.apply)(params, *jargs)

    pvit = vit.VisionTransformer(port_config(fcfg, vit.ViTConfig))
    pvit.load_state_dict(convert.vit_state_dict_from_flax(vparams, fcfg))
    tokens = loop.make_image_encode_fn(pvit, (24, 40))(t(images))
    np.testing.assert_allclose(tokens.numpy(), np.asarray(jtokens),
                               **MODEL_TOL)
    model = fusion.SegmentationPipeline(port_pipeline_config(pcfg))
    model.load_state_dict(convert.pipeline_state_dict_from_flax(params))
    tb = {k: t(v) for k, v in batch.items()}
    with torch.no_grad():
        got = model(tb["points"], tb["point_valid"], tokens,
                    tb["cam_intrinsics"], tb["lidar2cam"])
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)

    # eval step on the SAME logits: CELSLoss forward + confusion matrix
    jloss = jlosses.CELSLoss(weight=np.ones(16, np.float32))
    jout = jloss(want, jnp.asarray(batch["labels"]),
                 jnp.asarray(batch["mask"]))
    step = loop.make_eval_step(losses.CELSLoss(weight=np.ones(16)), 16)
    m = step(lambda *a: t(np.asarray(want)), tb, tokens)
    np.testing.assert_allclose(float(m["ce"]), float(jout.ce), **TOL)
    np.testing.assert_allclose(float(m["lovasz"]), float(jout.lovasz),
                               **TOL)
    assert int(m["correct"]) == int(jout.num_correct)
    assert int(m["valid"]) == int(jout.num_valid)
    np.testing.assert_array_equal(m["confusion"].numpy(), np.asarray(
        jmetrics.confusion_matrix(jout.predictions, batch["labels"], 16,
                                  jout.valid)))


def test_lovasz_and_losses_match(rng):
    N, C = 700, 16
    logits = (rng.normal(size=(2, N // 2, C)) * 2).astype(np.float32)
    probs = np.array(jax.nn.softmax(logits, -1)).reshape(N, C)
    labels0 = rng.integers(0, C, size=N).astype(np.int32)
    labels0[:50] = 3                     # a populated class; ties below
    probs[:20] = probs[20]
    valid = rng.random(N) > 0.2
    got = float(losses.lovasz_softmax(t(probs), t(labels0), t(valid)))
    exact = float(jlosses.lovasz_softmax(jnp.asarray(probs),
                                         jnp.asarray(labels0),
                                         jnp.asarray(valid), exact_sort=True))
    quantised = float(jlosses.lovasz_softmax(
        jnp.asarray(probs), jnp.asarray(labels0), jnp.asarray(valid)))
    np.testing.assert_allclose(got, exact, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, quantised, atol=1e-5, rtol=1e-5)
    w = rng.random(C).astype(np.float32) + 0.5
    l0 = labels0.reshape(2, -1)
    v = valid.reshape(2, -1)
    np.testing.assert_allclose(
        float(losses.weighted_cross_entropy(t(logits), t(l0), t(v), t(w))),
        float(jlosses.weighted_cross_entropy(logits, l0, v, w)), **TOL)


def test_metrics_and_accumulator_match(rng):
    cms = [rng.integers(0, 50, size=(16, 16)) for _ in range(3)]
    want = jmetrics.evaluate_from_confusion(jnp.asarray(sum(cms)), 3.0,
                                            500.0, 800.0, 3)
    got = metrics.evaluate_from_confusion(torch.as_tensor(sum(cms)), 3.0,
                                          500.0, 800.0, 3)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)
    assert metrics.format_metrics(got) == jmetrics.format_metrics(want)

    jacc, acc = jloop.MetricAccumulator(16, fold_every=2), \
        loop.MetricAccumulator(16, fold_every=2)
    for i, cm in enumerate(cms):
        m = dict(loss=1.0 + i, correct=100 + i, valid=300, confusion=cm)
        jacc.add({k: jnp.asarray(v) for k, v in m.items()})
        acc.add({k: torch.as_tensor(v) for k, v in m.items()})
    jm, pm = jacc.metrics(), acc.metrics()
    for k in jm:
        np.testing.assert_allclose(pm[k], np.asarray(jm[k]), **TOL)


def _tiny_config(tmp_path):
    cfg = {
        "debug": True,
        "dataset_params": {
            "label_mapping": os.path.join(
                ROOT, "configs/label_mapping/nuscenes.yaml"),
            "class_weights": [1.0] * 16,
            **{f"{s}_data_loader": {"data_path": "", "batch_size": 2,
                                    "shuffle": False, "num_workers": 0}
               for s in ("train", "val", "test")},
            "lidar": {"voxel_size": 0.8},
        },
        "train_params": {
            "train_best_weights": False,
            "best_model_path": str(tmp_path / "ckpt"),
            "checkpoint_path": str(tmp_path / "ckpt"),
            "image_encoder": "dinov2", "mlp_class": 16, "max_num_epochs": 1,
            "learning_rate": 0.001, "optimizer": "AdamW",
            "lr_scheduler": "none", "momentum": 0.9, "nesterov": False,
            "weight_decay": 0.0, "lambda_lovasz": 1,
        },
        "test_params": {"checkpoint_path": str(tmp_path / "ckpt")},
        "tpu_params": {
            "point_capacity": 1024, "voxel_capacity": 512,
            "window_size": 128, "intensity_mode": "mean",
            "devoxelize_mode": "own", "use_pallas": True,
            "compute_dtype": "float32", "mesh_shape": [1],
            "dataset": "synthetic", "synthetic_samples": 8,
            "synthetic_points": 1000, "synthetic_image_hw": [90, 160],
        },
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_main_infer_runs_end_to_end_on_cpu(tmp_path, capsys):
    from tpu3dssf_torch.cli.main_infer import main
    from tpu3dssf_torch.kernels.modules import flash_attention as fa

    before = fa.LAUNCHES
    out = main(["--config", _tiny_config(tmp_path), "--device", "cpu"])
    assert fa.LAUNCHES == before          # CPU: the plain version only
    for k in ("loss", "overall_acc", "mean_iou", "f1"):
        assert np.isfinite(out[k])
    assert 0.0 <= float(out["overall_acc"]) <= 1.0
    text = capsys.readouterr().out
    assert "EVALUATION METRICS" in text
    assert "streamed 1 batches, 2,000 valid points" in text


def test_main_infer_refuses_to_fall_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would use it")
    from tpu3dssf_torch.cli.main_infer import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config", _tiny_config(tmp_path)])


def test_port_imports_no_jax():
    """Every module of the port imports without JAX and without the JAX
    package ``tpu3dssf``: the port keeps its own copies of the host code.
    ``tpu3dssf_torch.kernels`` exports the functions ``tpu3dssf.kernels``
    exports, and ``tpu3dssf_torch.kernels.modules`` reaches the modules
    those names shadow."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tpu3dssf_torch\n"
        "for m in pkgutil.walk_packages(tpu3dssf_torch.__path__,"
        " 'tpu3dssf_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'optax', 'tpu3dssf'))\n"
        "n = sum(m.startswith('tpu3dssf_torch.') for m in sys.modules)\n"
        "assert n >= 30, n\n"
        "new = {'tpu3dssf_torch.cli.main_train', 'tpu3dssf_torch.train.state',"
        " 'tpu3dssf_torch.train.checkpoint', 'tpu3dssf_torch.config',"
        " 'tpu3dssf_torch.data.synthetic', 'tpu3dssf_torch.data.pipeline',"
        " 'tpu3dssf_torch.data.nuscenes_index', 'tpu3dssf_torch.data.native',"
        " 'tpu3dssf_torch.data.class_weights', 'tpu3dssf_torch.utils.logging',"
        " 'tpu3dssf_torch.utils.viz', 'tpu3dssf_torch.kernels.knn',"
        " 'tpu3dssf_torch.models.lidar_only', 'tpu3dssf_torch.cli.main_test',"
        " 'tpu3dssf_torch.cli.main_sample',"
        " 'tpu3dssf_torch.kernels.flash_attention',"
        " 'tpu3dssf_torch.kernels.window_attention',"
        " 'tpu3dssf_torch.kernels.modules',"
        " 'tpu3dssf_torch.models.vit_port', 'tpu3dssf_torch.kernels.ops',"
        " 'tpu3dssf_torch.export', 'tpu3dssf_torch.cli.export_model',"
        " 'tpu3dssf_torch.utils.constants', 'tpu3dssf_torch.parallel',"
        " 'tpu3dssf_torch.parallel.mesh', 'tpu3dssf_torch.parallel.sp',"
        " 'tpu3dssf_torch.cli.parity_ab', 'tpu3dssf_torch.cli.convergence'}\n"
        "assert new <= set(sys.modules), new - set(sys.modules)\n"
        "import tpu3dssf_torch.kernels as k\n"
        "names = ('flash_attention', 'mha_reference', 'window_attention')\n"
        "assert all(n in k.__all__ and callable(getattr(k, n))"
        " for n in names), k.__all__\n"
        "from tpu3dssf_torch.kernels import modules\n"
        "assert all(getattr(modules, n).__name__ == 'tpu3dssf_torch.kernels.'"
        " + n for n in modules.__all__), modules.__all__\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
