"""The port's own copies of the host modules vs the JAX package's.

``tpu3dssf_torch.config``, ``.data`` and ``.utils.logging`` are copies of
``tpu3dssf``'s JAX-free host code (the port imports nothing of the JAX
package). Each must give exactly what the original gives on the same
input: config fields, synthetic arrays, packed batches, class weights and
JSONL records (all compared exactly; the logger's time stamp is left out).
So must the host helpers the port rewrote: ``overall_accuracy``,
``StepTimer`` (on the same patched clock) and the sweep launcher's choice
and split of lines (``tpu3dssf_torch/cli/sweep.py`` against
``scripts/sweep.py``, with both CLIs' ``main_train`` patched to record
their argv).
"""

import dataclasses
import glob
import importlib.util
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

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


def test_overall_accuracy_matches(rng):
    from tpu3dssf.metrics import overall_accuracy as joverall
    from tpu3dssf_torch.metrics import overall_accuracy
    for cm in (rng.integers(0, 1000, (16, 16)), np.zeros((16, 16), int),
               np.diag(rng.integers(0, 50, 16))):
        got = float(overall_accuracy(torch.from_numpy(cm)))
        assert got == float(joverall(cm))
        assert got == (np.trace(cm) / max(cm.sum(), 1)).astype(np.float32)


def _clock(monkeypatch, times):
    """``time.perf_counter`` replaced by a clock that reads ``times`` in
    turn."""
    it = iter(times)
    monkeypatch.setattr(time, "perf_counter", lambda: next(it))


def test_step_timer_matches(monkeypatch):
    from tpu3dssf.utils.timing import StepTimer as JStepTimer
    from tpu3dssf_torch.utils import StepTimer
    times = [0.0, 0.01, 0.03, 0.06, 0.10, 0.15, 0.21]
    means = {}
    for cls in (StepTimer, JStepTimer):
        _clock(monkeypatch, times)
        timer = cls(window=3)
        seen = [timer.mean_ms]
        for _ in times:
            timer.tick()
            seen.append(timer.mean_ms)
        means[cls] = seen
    assert means[StepTimer] == means[JStepTimer]
    assert means[StepTimer][0] == 0.0
    assert means[StepTimer][-1] == pytest.approx(1e3 * (0.04 + 0.05 + 0.06)
                                                 / 3)


def test_measure_efficiency_and_peak_on_the_cpu(monkeypatch):
    from tpu3dssf_torch.utils import measure_efficiency, peak_hbm_mb
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _clock(monkeypatch, [1.0, 1.5])
    out, info = measure_efficiency(lambda x, y=0: x + y, 2, y=3)
    assert out == 5
    assert info == {"runtime_sec": 0.5, "mem_alloc_MB": 0.0}
    assert peak_hbm_mb("cpu") == 0.0


def _jax_sweep():
    spec = importlib.util.spec_from_file_location(
        "jax_sweep", os.path.join(ROOT, "scripts", "sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("index", [None, 0, 2])
def test_sweep_runs_the_lines_scripts_sweep_runs(tmp_path, monkeypatch,
                                                 capsys, index):
    import tpu3dssf.cli.main_train as jmain_train
    import tpu3dssf_torch.cli.main_train as main_train
    from tpu3dssf_torch.cli import sweep
    params = tmp_path / "sweep.txt"
    params.write_text("# one main_train argv per line\n"
                      "--config configs/a.yaml\n"
                      "\n"
                      "   \n"
                      "--config 'configs/with space.yaml' --resume\n"
                      "  # indented: not a comment line for either\n"
                      "--config configs/b.yaml --tee-log   \n")
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(main_train, "main", calls["port"].append)
    monkeypatch.setattr(jmain_train, "main", calls["jax"].append)
    argv = ["--params", str(params)]
    if index is not None:
        argv += ["--index", str(index)]
    sweep.main(argv)
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["sweep.py"] + argv)
    _jax_sweep().main()
    assert capsys.readouterr().out == port_out
    assert calls["port"] == calls["jax"]
    assert len(calls["port"]) == (4 if index is None else 1)
    if index == 2:
        assert calls["port"] == [["#", "indented:", "not", "a", "comment",
                                  "line", "for", "either"]]
