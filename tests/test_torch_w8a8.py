"""The port's W8A8 ViT (``QuantDense``, ``quantize_vit``, the converter's
W8A8 trees) against the JAX package's, on the CPU in f32.

Tolerances and what they allow for:
* ``kernel_q`` bit for bit, ``scale`` and ``bias`` equal: both sides fold
  LayerScale and quantize with the same f32 operations (IEEE division).
* activations ``x_q``: equal but for ±1 flips, counted, on at most
  ``FLIP_SHARE`` of the entries. JAX runs jitted, and XLA turns ``amax /
  127`` into ``amax · (1/127)``, one ulp off the port's IEEE division now
  and then; in the whole ViT each layer's input also differs by f32
  rounding (other sum orders), so an entry at a rounding boundary may
  land on the other integer.
* outputs: within ``OUT_TOL`` · max |JAX|. Without a flip the two sides
  differ by f32 rounding only: the int32 products are exact, the scales
  one ulp apart at most, the float layers as in tests/test_torch_vit.py
  (1e-4 there, over two blocks); 1e-5 of the largest value covers that
  (measured: under 3e-7 of it).
  A flip moves one output row by up to ``a · scale · 127``, which a tiny
  layer sums over few inputs, so the test also asserts that no flip
  happened in the cases it holds to ``OUT_TOL`` (each flip is counted and
  printed).
* W8A8 against float in the port: nonzero and below 0.05 · max(max |float|,
  1), as tests/test_vit.py holds JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_convert import port_config, t, to_numpy_tree
from tests.test_torch_vit import _dinov3_like, _params
from tpu3dssf.models import vit as jvit
from tpu3dssf_torch import convert
from tpu3dssf_torch.models import vit

FLIP_SHARE = 1e-3
OUT_TOL = 1e-5
QUANT_ERR = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(rng):
    return rng.normal(size=(2, 24, 40, 3)).astype(np.float32)


def _float_and_quant(rng, scan):
    """A tiny RoPE ViT with LayerScale (O(1) gammas): its JAX config,
    images, float params and JAX's ``quantize_vit`` of them."""
    cfg = _dinov3_like(scan_layers=scan, layerscale_init=1.0)
    images = _images(rng)
    params = _params(rng, cfg, images)
    qparams, qcfg = jvit.quantize_vit(params, cfg)
    return cfg, images, params, to_numpy_tree(qparams), qcfg


@pytest.fixture(scope="module", params=[False, True],
                ids=["unrolled", "scan"])
def trees(request):
    """:func:`_float_and_quant` of the unrolled and of the scan tree, made
    once per module."""
    return _float_and_quant(np.random.default_rng(0), request.param)


def _port_quantized(cfg, params):
    """The port's ViT on the converted float params, then its own
    ``quantize_vit``."""
    model = vit.VisionTransformer(port_config(cfg, vit.ViTConfig))
    model.load_state_dict(convert.vit_state_dict_from_flax(params, cfg))
    return vit.quantize_vit(model)


class _Recorder:
    """Records the int8 activations of every quantized product on both
    sides, in call order: JAX's through ``jax.lax.dot_general`` (a host
    callback, ordered, so it runs inside a jitted apply), the port's
    through ``QuantDense.quantize``."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        dot, quantize = jax.lax.dot_general, vit.QuantDense.quantize

        def record_dot(x, *args, **kwargs):
            if x.dtype == jnp.int8:
                jax.debug.callback(
                    lambda v: self.jax.append(np.asarray(v)), x,
                    ordered=True)
            return dot(x, *args, **kwargs)

        def record_quantize(x, amax=None):
            x_q, a = quantize(x, amax)
            self.port.append(x_q.numpy())
            return x_q, a

        monkeypatch.setattr(jax.lax, "dot_general", record_dot)
        monkeypatch.setattr(vit.QuantDense, "quantize",
                            staticmethod(record_quantize))

    def flips(self):
        """(entries differing, entries in all): each difference at most 1."""
        assert len(self.jax) == len(self.port) > 0
        n = total = 0
        for a, b in zip(self.jax, self.port):
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1, d.max()
            n += int(np.count_nonzero(d))
            total += d.size
        return n, total


def _held(got, want, flips):
    n, total = flips
    print(f"x_q flips: {n} of {total}")
    assert n <= FLIP_SHARE * total
    assert n == 0, "a flip: the output tolerance below assumes none"
    err = float(np.abs(got - want).max())
    print(f"max error {err:.3g} of max |JAX| {float(np.abs(want).max()):.3g}")
    assert err <= OUT_TOL * float(np.abs(want).max()), err


def test_quantized_weights_equal_jax(trees):
    cfg, _, params, qparams, qcfg = trees
    model = _port_quantized(cfg, params)
    assert model.config.quant_int8 and model.config.layerscale_init is None
    got = model.state_dict()
    want = convert.vit_state_dict_from_flax(qparams, qcfg)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    qkv = model.blocks[0].qkv
    assert qkv.kernel_q.dtype == torch.int8 and qkv.kernel_q.is_contiguous()
    assert qkv.kernel_q.shape == (3 * cfg.hidden_size, cfg.hidden_size)


def test_converter_loads_jax_w8a8_trees(trees):
    cfg, images, _, qparams, qcfg = trees
    pcfg = port_config(qcfg, vit.ViTConfig)
    assert pcfg.quant_int8 and pcfg.layerscale_init is None
    model = vit.VisionTransformer(pcfg)
    model.load_state_dict(convert.vit_state_dict_from_flax(qparams, qcfg))
    for name in vit.QUANT_LAYERS:
        assert isinstance(getattr(model.blocks[1], name), vit.QuantDense)
    with torch.no_grad():
        out = model(t(images))["patch_features"]
    assert torch.isfinite(out).all()


def test_quant_dense_matches_jax(rng, monkeypatch):
    K, O = 64, 96
    w = rng.normal(size=(K, O)).astype(np.float32)
    scale = np.maximum(np.abs(w).max(0) / np.float32(127.0), 1e-12)
    tree = {"kernel_q": np.round(w / scale).astype(np.int8),
            "scale": scale.astype(np.float32),
            "bias": rng.normal(size=(O,)).astype(np.float32)}
    x = (rng.normal(size=(3, 40, K)) * rng.uniform(0.1, 10, (3, 40, 1))
         ).astype(np.float32)
    layer = vit.QuantDense(K, O)
    sd = convert.state_dict_from_flax({"layer": tree})
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    rec = _Recorder(monkeypatch)
    want = np.asarray(jax.jit(jvit.QuantDense(O).apply)(
        {"params": tree}, x))
    jax.effects_barrier()
    with torch.no_grad():
        got = layer(t(x)).numpy()
    _held(got, want, rec.flips())


def test_w8a8_vit_matches_jax(trees, monkeypatch):
    cfg, images, _, qparams, qcfg = trees
    model = vit.VisionTransformer(port_config(qcfg, vit.ViTConfig))
    model.load_state_dict(convert.vit_state_dict_from_flax(qparams, qcfg))
    rec = _Recorder(monkeypatch)
    want = jax.jit(jvit.VisionTransformer(qcfg).apply)(qparams, images)
    jax.effects_barrier()
    with torch.no_grad():
        got = model(t(images))
    assert len(rec.port) == 4 * cfg.num_layers
    flips = rec.flips()
    for key in ("patch_features", "global_features"):
        _held(got[key].numpy(), np.asarray(want[key]), flips)


def test_w8a8_against_float_in_the_port(trees):
    cfg, images, params, _, _ = trees
    model = vit.VisionTransformer(port_config(cfg, vit.ViTConfig))
    model.load_state_dict(convert.vit_state_dict_from_flax(params, cfg))
    with torch.no_grad():
        ref = model(t(images))["patch_features"]
        out = vit.quantize_vit(model)(t(images))["patch_features"]
    err = float((out - ref).abs().max())
    assert 0.0 < err < QUANT_ERR * max(float(ref.abs().max()), 1.0), err
