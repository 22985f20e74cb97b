"""The port's own copies of the host modules vs the JAX package's.

``tpu3dssf_torch.config``, ``.data`` and ``.utils.logging`` are copies of
``tpu3dssf``'s JAX-free host code (the port imports nothing of the JAX
package). Each must give exactly what the original gives on the same
input: config fields, synthetic arrays, packed batches, class weights and
JSONL records (all compared exactly; the logger's time stamp is left out).
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

from tpu3dssf import config as jconfig
from tpu3dssf import data as jdata
from tpu3dssf.data import class_weights as jweights
from tpu3dssf.utils import logging as jlogging
from tpu3dssf_torch import config, data
from tpu3dssf_torch.data import class_weights
from tpu3dssf_torch.utils import logging

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def _eq_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq_tree(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_load_config_gives_the_same_fields(path):
    got = dataclasses.asdict(config.load_config(path))
    want = dataclasses.asdict(jconfig.load_config(path))
    _eq_tree(got, want)
    assert got["image_encoder"] in config.IMAGE_ENCODERS


def test_label_mapping_and_class_dict_match():
    path = os.path.join(ROOT, "configs", "label_mapping", "nuscenes.yaml")
    assert config.load_label_mapping(path) == jconfig.load_label_mapping(path)
    assert config.load_class_dict(path) == jconfig.load_class_dict(path)


@pytest.mark.parametrize("render", [False, True])
def test_synthetic_scenes_are_identical(render):
    kw = dict(num_samples=3, num_points=1500, image_hw=(45, 80), seed=7,
              render_semantics=render)
    got, want = data.SyntheticNuScenes(**kw), jdata.SyntheticNuScenes(**kw)
    assert len(got) == len(want)
    for i in (0, 2):
        _eq_tree(got[i], want[i])


def test_host_pipeline_gives_identical_batches():
    kw = dict(num_samples=5, num_points=900, image_hw=(45, 80), seed=4)
    pipe = dict(batch_size=2, point_capacity=1024, shuffle=True, seed=3,
                drop_last=False)
    got = list(data.HostDataPipeline(data.SyntheticNuScenes(**kw), **pipe))
    want = list(jdata.HostDataPipeline(jdata.SyntheticNuScenes(**kw),
                                       **pipe))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _eq_tree(a, b)


def test_class_weights_match():
    counts = np.array([5, 900, 30, 0, 12, 4000, 7, 1, 66, 2, 3, 8, 9, 10,
                       11, 250])
    for name in ("sqrt_inverse_weights", "soft_compressed_weights",
                 "log_compressed_weights"):
        np.testing.assert_array_equal(getattr(class_weights, name)(counts),
                                      getattr(jweights, name)(counts))


def test_jsonl_logger_writes_the_same_records(tmp_path):
    records = [{"train/loss": np.float32(1.25), "step": 3},
               {"val/acc": 0.5, "epoch": 0, "note": "x"}]
    for mod, sub in ((logging, "port"), (jlogging, "jax")):
        log = mod.create_logger(str(tmp_path / sub))
        assert type(log).__name__ == "JsonlLogger"
        for r in records:
            log.log(r)
        log.finish()

    def read(sub):
        with open(tmp_path / sub / "metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
        return [{k: v for k, v in r.items() if k != "_time"} for r in rows]

    assert read("port") == read("jax")
    assert len(read("port")) == 2


@pytest.mark.parametrize("C,H,S", [(32, 4, 2), (32, 4, 4), (384, 6, 2),
                                   (384, 6, 3), (1024, 16, 2),
                                   (1024, 16, 8), (64, 1, 1)])
def test_qkv_tp_permutation_is_the_originals(C, H, S):
    """The port's numpy copy of ``qkv_tp_permutation``, index for index."""
    from tpu3dssf.models.vit import qkv_tp_permutation as jperm
    from tpu3dssf_torch.models.vit import qkv_tp_permutation
    got = qkv_tp_permutation(C, H, S)
    np.testing.assert_array_equal(got, np.asarray(jperm(C, H, S)))
    assert sorted(got.tolist()) == list(range(3 * C))
