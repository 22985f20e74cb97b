"""Local DINO weights and checkpoints in the port's CLIs, on the CPU.

* ``tpu3dssf_torch.models.vit_port`` vs the JAX package's
  ``tpu3dssf.models.vit_port``: HF ``Dinov2Model`` and ``DINOv3ViTModel``
  built at random init from small configs (skipped where ``transformers``
  is missing; nothing is downloaded), their state dicts mapped by both
  ports; the port's ViT (K1 route with RoPE) against JAX's ViT on the same
  weights and against HF's own patch tokens. The same tree from both ports.
* The port's safetensors reader against ``safetensors``' own, and
  ``_find_local_checkpoint`` under each environment variable against
  JAX's.
* ``try_load_pretrained`` from a file into the port's ViT, and
  ``common.build_vit`` without one (the seeded init, said so).
* ``main_infer`` restores the checkpoint ``main_train`` wrote: its test
  metrics equal ``main_test``'s.

Tolerance: whole ViTs at atol = rtol = 1e-4 (f32 sums over layers in
another order); trees, files and metrics exact.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_convert import port_config
from tests.test_torch_pipeline import _tiny_config
from tpu3dssf.models import vit as jvit
from tpu3dssf.models import vit_port as jport
from tpu3dssf_torch import convert
from tpu3dssf_torch.models import vit, vit_port

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


def _randomize(model, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return model.eval()


def _hf_dinov2():
    from transformers import Dinov2Config, Dinov2Model
    hf = _randomize(Dinov2Model(Dinov2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        mlp_ratio=4, image_size=28, patch_size=14, layerscale_value=0.8)))
    cfg = jvit.ViTConfig(patch_size=14, image_size=(28, 28), hidden_size=32,
                         num_layers=2, num_heads=4, use_rope=False)
    return hf, cfg, 1


def _hf_dinov3():
    from transformers import DINOv3ViTConfig, DINOv3ViTModel
    hf = _randomize(DINOv3ViTModel(DINOv3ViTConfig(
        hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=512, image_size=32, patch_size=16,
        num_register_tokens=4, layerscale_value=0.8, rope_theta=100.0)),
        seed=1)
    # D = 64 (the RoPE models' head dim); a non-square 2 x 3 patch grid
    cfg = jvit.ViTConfig(patch_size=16, image_size=(32, 48), hidden_size=128,
                         num_layers=2, num_heads=2, num_register_tokens=4,
                         use_rope=True, ln_eps=1e-5, rope_theta=100.0)
    return hf, cfg, 5


@pytest.mark.parametrize("make", [_hf_dinov2, _hf_dinov3])
def test_ported_hf_weights_match_jax_and_hf(rng, make):
    pytest.importorskip("transformers")
    hf, cfg, n_prefix = make()
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    tree = vit_port.port_hf_state_dict(sd, port_config(cfg, vit.ViTConfig))
    jtree = jport.port_hf_state_dict(sd, cfg)
    flat, jflat = (jax.tree_util.tree_flatten_with_path(x)[0]
                   for x in (tree, jtree))
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    for (_, a), (_, b) in zip(flat, jflat):
        np.testing.assert_array_equal(a, b)

    px = rng.normal(size=(2, 3) + cfg.image_size).astype(np.float32)
    images = np.transpose(px, (0, 2, 3, 1))
    want = jvit.VisionTransformer(cfg).apply(jtree, images)
    model = vit.VisionTransformer(port_config(cfg, vit.ViTConfig))
    model.load_state_dict(convert.vit_state_dict_from_flax(tree, cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
        hf_out = hf(torch.from_numpy(px)).last_hidden_state.numpy()
    np.testing.assert_allclose(got["patch_features"].numpy(),
                               np.asarray(want["patch_features"]),
                               **MODEL_TOL)
    np.testing.assert_allclose(got["patch_features"].numpy(),
                               hf_out[:, n_prefix:], **MODEL_TOL)


def test_safetensors_reader_matches_safetensors(tmp_path, rng):
    st_numpy = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    arrays = {"w": rng.normal(size=(3, 5)).astype(np.float32),
              "h": rng.normal(size=(7,)).astype(np.float16),
              "i": np.arange(6, dtype=np.int64).reshape(2, 3),
              "m": np.array([True, False, True]),
              "s": np.array(2.5, np.float32)}
    path = str(tmp_path / "a.safetensors")
    st_numpy.save_file(arrays, path, metadata={"format": "np"})
    got, want = vit_port.load_safetensors(path), st_numpy.load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    bf16 = str(tmp_path / "b.safetensors")
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    st_torch.save_file({"x": x.to(torch.bfloat16)}, bf16)
    np.testing.assert_array_equal(
        vit_port.load_safetensors(bf16)["x"],
        st_torch.load_file(bf16)["x"].float().numpy())


@pytest.mark.parametrize("where", ["explicit", "weights_dir", "default_dir",
                                   "hf_cache", "none"])
def test_find_local_checkpoint_as_jax(tmp_path, monkeypatch, where):
    monkeypatch.chdir(tmp_path)
    for var in ("TPU3DSSF_VIT_CHECKPOINT", "TPU3DSSF_WEIGHTS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    want = None
    if where == "explicit":
        want = str(tmp_path / "my.pth")
        monkeypatch.setenv("TPU3DSSF_VIT_CHECKPOINT", want)
    elif where == "weights_dir":
        monkeypatch.setenv("TPU3DSSF_WEIGHTS", str(tmp_path / "w"))
        want = str(tmp_path / "w" / "dinov3.bin")
    elif where == "default_dir":
        want = os.path.join("./weights", "dinov3.safetensors")
    elif where == "hf_cache":
        want = str(tmp_path / "hf" / "hub" / (
            "models--facebook--dinov3-vits16-pretrain-lvd1689m") /
            "snapshots" / "abc" / "model.safetensors")
    if want is not None:
        os.makedirs(os.path.dirname(os.path.abspath(want)), exist_ok=True)
        open(want, "wb").close()
    got = vit_port._find_local_checkpoint("dinov3")
    assert got == want == jport._find_local_checkpoint("dinov3")


def test_try_load_pretrained_loads_a_local_file(tmp_path, monkeypatch,
                                                capsys):
    st_torch = pytest.importorskip("safetensors.torch")
    pytest.importorskip("transformers")
    hf, cfg, n_prefix = _hf_dinov3()
    path = str(tmp_path / "dinov3.safetensors")
    st_torch.save_file({k: v.contiguous() for k, v in
                        hf.state_dict().items()}, path)
    monkeypatch.setenv("TPU3DSSF_VIT_CHECKPOINT", path)
    model = vit.VisionTransformer(port_config(cfg, vit.ViTConfig))
    assert vit_port.try_load_pretrained("dinov3", model) == path
    assert f"porting dinov3 weights from {path}" in capsys.readouterr().out
    px = np.random.default_rng(2).normal(size=(1, 3, 32, 48)).astype(
        np.float32)
    with torch.no_grad():
        got = vit.fold_layerscale(model)(
            torch.from_numpy(px).permute(0, 2, 3, 1))["patch_features"]
        want = hf(torch.from_numpy(px)).last_hidden_state[:, n_prefix:]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **MODEL_TOL)


def test_build_vit_keeps_the_seeded_init_without_a_file(tmp_path,
                                                        monkeypatch, capsys):
    from tpu3dssf_torch.cli import common
    from tpu3dssf_torch.models.layers import init_weights

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("TPU3DSSF_VIT_CHECKPOINT", raising=False)
    monkeypatch.setenv("TPU3DSSF_WEIGHTS", str(tmp_path / "none"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    cfg = common.load_config(_tiny_config(tmp_path))    # dinov2, f32
    model, vit_cfg = common.build_vit(cfg, "cpu", seed=0)
    assert "no pretrained dinov2 weights found locally" in \
        capsys.readouterr().out
    want = vit.fold_layerscale(init_weights(vit.VisionTransformer(vit_cfg),
                                            0))
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              want.state_dict().items()):
        assert torch.equal(a, b), k


def test_main_infer_restores_the_trained_checkpoint(tmp_path, capsys):
    """After ``main_train``, ``main_infer`` (test split) and ``main_test``
    evaluate the same restored state: the same metrics."""
    from tpu3dssf_torch.cli import main_infer, main_test, main_train

    path = _tiny_config(tmp_path)
    raw = yaml.safe_load(open(path))
    raw["tpu_params"]["synthetic_samples"] = 4
    # the checkpoint holds the pipeline, not the frozen encoder: the
    # LiDAR-only model keeps the test small
    raw["train_params"]["image_encoder"] = "none"
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    main_train.main(["--config", path, "--device", "cpu"])
    capsys.readouterr()
    infer = main_infer.main(["--config", path, "--split", "test",
                             "--device", "cpu"])
    text = capsys.readouterr().out
    assert f"loaded checkpoint step 0 from {tmp_path / 'ckpt'}" in text
    assert "per chip)" in text
    test = main_test.main(["--config", path, "--device", "cpu"])
    assert "Loaded checkpoint from" in capsys.readouterr().out
    assert sorted(infer) == sorted(test)
    for k in test:
        np.testing.assert_array_equal(np.asarray(infer[k]),
                                      np.asarray(test[k]), err_msg=k)
