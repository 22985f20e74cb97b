"""The port's benchmark entry points (``tpu3dssf_torch.cli.bench``,
``bench_train``, ``bench_vitl``) on the CPU at tiny sizes.

The bench frame (images → preprocess → ViT → pipeline, one step) is held
against the JAX package's composition of the same functions, as the root
``bench.py`` builds ``fused_infer``, on converted weights, at
tests/test_torch_pipeline.py's model tolerance (atol = rtol = 1e-4: f32
sums over many layers in another order). The other entry points are run
at tiny sizes for finite numbers and the records they print.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_convert import port_config, to_numpy_tree
from tpu3dssf.models import fusion as jfusion
from tpu3dssf.models import ptv3 as jptv3
from tpu3dssf.models import vit as jvit
from tpu3dssf_torch import convert
from tpu3dssf_torch.cli import bench, bench_train, bench_vitl
from tpu3dssf_torch.models import ptv3, vit

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_ptv3(**kw):
    return jptv3.PTv3Config(
        enc_depths=(1, 1), enc_channels=(16, 32), enc_heads=(1, 2),
        enc_window=(32, 32), dec_depths=(1,), dec_channels=(16,),
        dec_heads=(1,), dec_window=(32,), use_pallas=False, **kw)


def _tiny_vit(**kw):
    return jvit.ViTConfig(patch_size=8, image_size=(24, 40), hidden_size=32,
                          num_layers=1, num_heads=2, num_register_tokens=4,
                          use_rope=True, ln_eps=1e-5, **kw)


@pytest.fixture(scope="module")
def frame():
    """The port's frame at a tiny size on JAX's weights, and JAX's frame:
    (port record, port info, JAX logits, inputs)."""
    vcfg = _tiny_vit(scan_layers=True)
    jpt = _tiny_ptv3()
    pvit_cfg, pipe_cfg = bench.frame_configs(
        dtype=torch.float32, voxel_capacity=256,
        vit_cfg=port_config(vcfg, vit.ViTConfig),
        ptv3_cfg=port_config(jpt, ptv3.PTv3Config))
    inputs = bench.frame_inputs(1, num_points=256, image_hw=(45, 80))
    jin = {k: jnp.asarray(v.numpy()) for k, v in inputs.items()}

    # bench.py's fused_infer: encode (preprocess, the six views as one
    # batch, patch features) and the pipeline, jitted as one program
    jvit_model = jvit.VisionTransformer(vcfg)
    vparams = jax.jit(jvit_model.init)(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 24, 40, 3)))
    vparams, fcfg = jvit.fold_layerscale(vparams, vcfg)
    vparams = to_numpy_tree(vparams)
    jvit_model = jvit.VisionTransformer(fcfg)
    jpcfg = jfusion.PipelineConfig(
        fusion=jfusion.FusionConfig(
            point_feat_dim=16, patch_tok_dim=32, patch_size=8,
            encoder_size=(24, 40)),
        ptv3=jpt, voxel_size=0.1, voxel_capacity=256)
    assert port_config(jpcfg.fusion, type(pipe_cfg.fusion)) == \
        pipe_cfg.fusion
    jmodel = jfusion.SegmentationPipeline(jpcfg)
    tokens0 = jnp.zeros((1, 6, fcfg.num_patches, fcfg.hidden_size))
    params = to_numpy_tree(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jin["points"], jin["point_valid"], tokens0,
        jin["cam_intrinsics"], jin["lidar2cam"]))

    @jax.jit
    def fused_infer(imgs, pts, pv, cam_k, l2c):
        x = jvit.preprocess_images(imgs, fcfg.image_size)
        x = x.reshape((6,) + x.shape[2:])
        t = jvit_model.apply(vparams, x)["patch_features"]
        t = t.reshape(1, 6, t.shape[1], t.shape[2])
        return jmodel.apply(params, pts, pv, t, cam_k, l2c)

    want = np.asarray(fused_infer(jin["images"], jin["points"],
                                  jin["point_valid"], jin["cam_intrinsics"],
                                  jin["lidar2cam"]))

    pvit = vit.VisionTransformer(dataclasses.replace(
        pvit_cfg, layerscale_init=None))
    pvit.load_state_dict(convert.vit_state_dict_from_flax(vparams, fcfg))
    from tpu3dssf_torch.models.fusion import SegmentationPipeline
    model = SegmentationPipeline(pipe_cfg)
    model.load_state_dict(convert.pipeline_state_dict_from_flax(params))
    result, info = bench.run(pvit.eval(), model.eval(), inputs, reps=10)
    return result, info, want, inputs


def test_bench_frame_matches_jax_fused_infer(frame):
    _, info, want, inputs = frame
    got = info["logits"].numpy()
    assert got.shape == want.shape == (1, 256, 16)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    assert info["points"] == int(inputs["point_valid"].sum()) == 256


def test_bench_record_has_bench_py_keys(frame):
    result = frame[0]
    assert list(result) == ["metric", "value", "unit", "vs_baseline",
                            "peak_hbm_mb", "peak_hbm_source"]
    assert result["metric"] == "fused_points_per_sec_per_chip"
    assert result["unit"] == "points/s"
    assert result["peak_hbm_source"] == "runtime"
    assert result["peak_hbm_mb"] == 0.0          # the CPU: no device memory
    assert result["value"] > 0 and math.isfinite(result["value"])
    assert result["vs_baseline"] == pytest.approx(
        result["value"] / 100000, abs=5e-4)
    assert json.loads(json.dumps(result)) == result


def test_bench_frame_configs_are_bench_py_s():
    vit_cfg, pipe = bench.frame_configs()
    assert (vit_cfg.hidden_size, vit_cfg.num_layers, vit_cfg.patch_size,
            vit_cfg.image_size, vit_cfg.dtype) == (
                384, 12, 16, (640, 1138), torch.bfloat16)
    assert pipe.voxel_capacity == 25600 and pipe.voxel_size == 0.1
    assert pipe.ptv3.enc_window == (1024,) * 5
    assert pipe.ptv3.dec_window == (1024,) * 4
    assert pipe.fusion.patch_tok_dim == 384
    assert pipe.fusion.point_feat_dim == 64
    assert bench.frame_configs("vitl")[0].hidden_size == 1024


def test_bench_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_train.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_vitl.main([])


def test_bench_train_rows_run_on_the_cpu(capsys):
    rows = bench_train.main_rows(
        CPU, torch.float32, batch_size=2, points=128, voxel_capacity=64,
        tokens_shape=(6, 15, 8), ptv3_cfg=port_config(_tiny_ptv3(),
                                                      ptv3.PTv3Config),
        reps=2)
    assert list(rows) == ["lidar-only", "lidar-only+remat", "fusion"]
    for row in rows.values():
        assert row["ms"] > 0 and math.isfinite(row["points_per_s"])
        assert row["launches"] == {}         # the CPU: plain versions only
    split = rows["lidar-only"]
    for k in ("fwd_ms", "bwd_ms", "opt_misc_ms"):
        assert math.isfinite(split[k])
    text = capsys.readouterr().out
    assert "lidar-only+remat     train step (B=2, 128 pts)" in text
    assert "fwd" in text and "opt+misc" in text


def test_bench_train_sweep_reports_a_failed_batch_and_goes_on(capsys):
    rows = bench_train.batch_scaling(
        [2, 3], CPU, torch.float32, accum=2, points=128, voxel_capacity=64,
        tokens_shape=(6, 15, 8),
        ptv3_cfg=port_config(_tiny_ptv3(), ptv3.PTv3Config), reps=2)
    assert math.isfinite(rows[2]["ms"])
    assert "not divisible by grad_accum=2" in rows[3]["failed"]
    text = capsys.readouterr().out
    assert "fusion train B= 2 (128 pts/sample, accum=2)" in text
    assert "fusion train B= 3, accum=2: FAILED ValueError" in text


def test_bench_vitl_modes_run_on_the_cpu():
    cfg = bench_vitl.vitl_config(torch.float32, port_config(
        _tiny_vit(), vit.ViTConfig))
    enc = bench_vitl.encode_row(cfg, CPU, reps=2, images=2)
    assert enc["out"].shape == (2, 15, 32)
    assert math.isfinite(enc["tokens_per_s"])
    blk = bench_vitl.block_row(cfg, CPU, reps=2, tokens=32, images=2)
    assert blk["out"].shape == (2, 32, 32)
    assert torch.isfinite(blk["out"]).all()
    assert blk["frame_ms"] == pytest.approx(cfg.num_layers * blk["ms"])
