"""The port's export (tpu3dssf_torch/export.py, the port of
tpu3dssf/export.py, and tpu3dssf_torch/cli/export_model.py) on the CPU.

A tiny ``SegmentationPipeline`` (tests/test_export.py's, weights moved from
flax by ``convert.py``): its artifact after a disk round trip equals the
eager forward bit for bit (the same ops in the same order), its graph holds
the ``tpu3dssf::*`` op nodes that a card's artifact would launch as Hopper
kernels, and it agrees with JAX's exported artifact of the same model on the
same seeded inputs within 1e-4 at f32 (the whole-slice tolerance of
tests/test_torch_pipeline.py: f32 sums over many layers in another order).
A tiny LiDAR-only model in the parity modes exports with its k-NN op; a
fresh process loads an artifact with no model code; the CLI writes one.
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

from tests.test_export import _tiny_pipeline as _jax_tiny_pipeline
from tests.test_torch_convert import port_pipeline_config, t, to_numpy_tree
from tests.test_torch_lidar import _lattice_points
from tests.test_torch_pipeline import _tiny_config
from tpu3dssf import export as jexport
from tpu3dssf_torch import convert
from tpu3dssf_torch.export import export_infer_bytes, load_exported
from tpu3dssf_torch.kernels import modules
from tpu3dssf_torch.models import fusion, lidar_only
from tpu3dssf_torch.models.layers import init_weights
from tpu3dssf_torch.models.ptv3 import PTv3Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
# modules a process that loads an artifact must not hold
MODEL_CODE = ("tpu3dssf_torch.models", "tpu3dssf_torch.voxel",
              "tpu3dssf_torch.serialization")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, B=1, P=128):
    """tests/test_export.py's inputs, as numpy."""
    pts = np.concatenate([rng.normal(size=(B, P, 3)) * 3,
                          rng.random((B, P, 1))], -1).astype(np.float32)
    valid = np.ones((B, P), bool)
    tokens = (rng.normal(size=(B, 6, 2840, 8)) * 0.02).astype(np.float32)
    K = np.zeros((B, 6, 3, 3), np.float32)
    K[:, :, 0, 0] = K[:, :, 1, 1] = 1266.0
    K[:, :, 0, 2], K[:, :, 1, 2], K[:, :, 2, 2] = 800.0, 450.0, 1.0
    Rt = np.tile(np.eye(4, dtype=np.float32), (B, 6, 1, 1))
    return pts, valid, tokens, K, Rt


@pytest.fixture(scope="module")
def tiny():
    """tests/test_export.py's tiny pipeline in JAX and in the port (the
    same weights), its inputs, and the port's artifact."""
    jmodel = _jax_tiny_pipeline()
    args = _inputs(np.random.default_rng(0))
    jargs = [jnp.asarray(a) for a in args]
    params = to_numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                *jargs))
    model = fusion.SegmentationPipeline(port_pipeline_config(jmodel.config))
    model.load_state_dict(convert.pipeline_state_dict_from_flax(params))
    model.eval()
    targs = tuple(t(a) for a in args)
    with torch.no_grad():
        eager = model(*targs)
    return dict(jmodel=jmodel, params=params, jargs=jargs, model=model,
                args=targs, eager=eager,
                blob=export_infer_bytes(model, targs))


def _op_nodes(blob):
    import io
    program = torch.export.load(io.BytesIO(blob))
    return sorted(str(n.target) for n in program.graph.nodes
                  if str(n.target).startswith("tpu3dssf."))


def test_export_roundtrip_equals_eager(tiny, tmp_path):
    path = tmp_path / "model.pt2"
    path.write_bytes(tiny["blob"])
    f = load_exported(path.read_bytes())
    before = modules.launch_counts()
    got = f(*tiny["args"])
    assert modules.launch_counts() == before       # CPU: plain versions
    torch.testing.assert_close(got, tiny["eager"], rtol=0, atol=0)
    # window 16: every PTv3 block (2 encoder, 1 decoder) on the window
    # route, one K6 op each
    assert _op_nodes(tiny["blob"]) == ["tpu3dssf.attention.default"] * 3


def test_export_agrees_with_jax_export(tiny):
    jmodel, params = tiny["jmodel"], tiny["params"]

    def infer(p, v, tok, k, rt):
        return jmodel.apply(params, p, v, tok, k, rt)

    jblob = jexport.export_infer_bytes(infer, tiny["jargs"])
    want = np.asarray(jexport.load_exported(jblob)(*tiny["jargs"]))
    got = load_exported(tiny["blob"])(*tiny["args"])
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


def test_parity_mode_model_exports_with_its_knn_op():
    ptv3 = PTv3Config(enc_depths=(1, 1), enc_channels=(16, 32),
                      enc_heads=(1, 2), enc_window=(128, 128),
                      dec_depths=(1,), dec_channels=(16,), dec_heads=(1,),
                      dec_window=(128,))
    cfg = fusion.PipelineConfig(
        fusion=fusion.FusionConfig(output_dim=16), ptv3=ptv3, voxel_size=0.5,
        voxel_capacity=512, intensity_mode="knn5", devoxelize_mode="nearest")
    model = init_weights(lidar_only.LidarSegmentationModel(cfg), 3).eval()
    pts, mask = _lattice_points(np.random.default_rng(1))
    args = (t(pts), t(mask))
    blob = export_infer_bytes(model, args)
    with torch.no_grad():
        want = model(*args)
    torch.testing.assert_close(load_exported(blob)(*args), want, rtol=0,
                               atol=0)
    # knn5 and nearest; the window-128 blocks at C in {16, 32} take K1
    assert _op_nodes(blob) == (["tpu3dssf.knn.default"] * 2
                               + ["tpu3dssf.packed_attention.default"] * 3)


def test_artifact_loads_without_model_code(tiny, tmp_path):
    (tmp_path / "model.pt2").write_bytes(tiny["blob"])
    torch.save({"args": tiny["args"], "want": tiny["eager"]},
               tmp_path / "io.pt")
    code = (
        "import sys, torch\n"
        "import tpu3dssf_torch.kernels\n"
        "from tpu3dssf_torch.export import load_exported\n"
        f"d = torch.load({str(tmp_path / 'io.pt')!r})\n"
        f"f = load_exported(open({str(tmp_path / 'model.pt2')!r}, 'rb')"
        ".read())\n"
        "assert torch.equal(f(*d['args']), d['want'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax',"
        " 'jaxlib', 'flax', 'optax', 'tpu3dssf') or m.startswith("
        f"{MODEL_CODE!r}))\n"
        "assert not bad, bad\n"
        "print('loaded', sorted(m for m in sys.modules"
        " if m.startswith('tpu3dssf_torch')))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "tpu3dssf_torch.kernels.ops" in res.stdout


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "tpu3dssf_torch.cli.export_model", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})


def _lidar_only_config(tmp_path):
    path = _tiny_config(tmp_path)
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw["train_params"]["image_encoder"] = "none"
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def test_cli_writes_the_artifact_on_cpu(tmp_path):
    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.train.checkpoint import save_checkpoint

    path = _lidar_only_config(tmp_path)
    cfg = common.load_config(path)
    model, _ = common.build_pipeline(cfg, None, "cpu", seed=9)
    save_checkpoint(str(tmp_path / "ckpt"), 4, common.init_state(cfg, model))
    out = tmp_path / "model.pt2"
    res = _cli("--config", path, "--out", str(out), "--checkpoint",
               str(tmp_path / "ckpt"), "--device", "cpu")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "restored checkpoint step 4" in res.stdout
    size = out.stat().st_size
    assert f"wrote {out} ({size / 1e6:.1f} MB, platform=cpu)" in res.stdout


def test_cli_refuses_to_fall_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would use it")
    res = _cli("--config", _lidar_only_config(tmp_path), "--out",
               str(tmp_path / "model.pt2"))
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not (tmp_path / "model.pt2").exists()
