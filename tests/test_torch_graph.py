"""The CUDA-graph wrapper of the port's steps (``tpu3dssf_torch.train.
graph``) and what it needs of the steps, on the CPU.

On the CPU there are no graphs: a graphed step is the eager step, which
these tests hold bit for bit. What the card needs of a step to be captured
is checked here on CPU tensors: no host read (``.item()``, ``float()``,
``bool()``), no operation whose output shape depends on the data, and no
tensor made from host data inside the step (a graph cannot replay a
host-to-device copy), in the encode, eval and train steps of the fusion
and the LiDAR parity models. Then the config rule that keeps a train step
eager, the metric sums, the launch-counter registry and the dropping of
graphs on a restore. tests/test_torch_cuda.py holds the graphs themselves
on the card.
"""

import dataclasses
import glob
import os
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_torch_lidar import _tiny_lidar_config
from tests.test_torch_pipeline import _tiny_config
from tpu3dssf_torch.cli import common
from tpu3dssf_torch.kernels import modules
from tpu3dssf_torch.train import graph, loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_metric_accumulator_copies_what_it_is_given():
    """One dict whose tensors the caller overwrites in place between adds
    (as a graph replay overwrites its outputs) sums like fresh dicts."""
    gen = torch.Generator().manual_seed(0)
    ms = [{"loss": torch.rand((), generator=gen, dtype=torch.float64),
           "correct": torch.randint(0, 50, (), generator=gen),
           "valid": torch.randint(50, 99, (), generator=gen),
           "confusion": torch.randint(0, 9, (4, 4), generator=gen)}
          for _ in range(3)]
    fresh, reused = loop.MetricAccumulator(4), loop.MetricAccumulator(4)
    buf = {k: torch.zeros_like(v) for k, v in ms[0].items()}
    for m in ms:
        fresh.add({k: v.clone() for k, v in m.items()})
        for k in buf:
            buf[k].copy_(m[k])
        reused.add(buf)
    want, got = fresh.metrics(), reused.metrics()
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(
        fresh._cm_h, sum(m["confusion"].numpy() for m in ms))


def _cfg(tmp_path, **train):
    cfg = common.load_config(_tiny_config(tmp_path))
    return dataclasses.replace(cfg, **train)


@pytest.mark.parametrize("change,words", [
    (dict(lr_scheduler="ReduceLROnPlateau"), "ReduceLROnPlateau"),
    (dict(skip_nonfinite=True), "skip_nonfinite"),
    (dict(optimizer="SGD"), "SGD"),
    (dict(drop_path=0.1), "drop_path"),
])
def test_config_rule_keeps_host_decisions_eager(tmp_path, capsys, change,
                                                words):
    reason = graph.eager_reason(_cfg(tmp_path, **change))
    assert reason is not None and words in reason
    step = loop.make_train_step(common.build_loss(_cfg(tmp_path)))
    assert graph.graph_train_step(step, reason) is step
    out = capsys.readouterr().out
    assert out.count("[graph] train step stays eager") == 1
    assert words in out


def test_config_rule_names_every_reason(tmp_path):
    reason = graph.eager_reason(_cfg(
        tmp_path, lr_scheduler="ReduceLROnPlateau", skip_nonfinite=True,
        optimizer="SGD", drop_path=0.2))
    assert len(reason.split("; ")) == 4


def test_every_shipped_config_is_graphed():
    """AdamW or Adam with a schedule torch can fill, no skip, no DropPath:
    every config in configs/ trains through a graph on the card."""
    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
    assert paths
    for path in paths:
        assert graph.eager_reason(common.load_config(path)) is None, path


def test_graphed_train_step_without_reason_splits_device_and_host(
        tmp_path, capsys):
    step = loop.make_train_step(common.build_loss(_cfg(tmp_path)))
    g = graph.graph_train_step(step)
    assert isinstance(g, graph.GraphedStep)
    assert g.step is step.update and g.after is step.advance
    assert "[graph]" not in capsys.readouterr().out


def _tiny_run(path):
    """The model, state, loss, eval step, encode fn and first train batch
    of the config at ``path``, on the CPU."""
    cfg = common.load_config(path)
    cpu = torch.device("cpu")
    encode, vit_cfg = common.build_image_encoder(cfg, cpu)
    model, _ = common.build_pipeline(cfg, vit_cfg, cpu)
    state = common.init_state(cfg, model, steps_per_epoch=4)
    loss_fn = common.build_loss(cfg)
    host = next(iter(common.build_dataloaders(cfg)["train"]))
    images = host.pop("images", None)
    batch = common.batch_to_device(host, cpu)
    if encode is not None:
        tokens = encode(torch.as_tensor(images))
    else:
        tokens = common.zero_tokens(cfg, vit_cfg, batch["points"].shape[0])
    return dict(cfg=cfg, model=model, state=state, loss_fn=loss_fn,
                encode=encode, images=images, batch=batch, tokens=tokens)


def test_graphed_steps_on_the_cpu_are_the_eager_steps(tmp_path):
    """Two states from one seed: three train steps each, graphed and eager,
    give the same bits, the same update count and schedule, and no graph;
    the graphed eval step gives the eager one's metrics."""
    path = _tiny_config(tmp_path)
    a, b = _tiny_run(path), _tiny_run(path)
    eager = loop.make_train_step(a["loss_fn"])
    graphed = graph.graph_train_step(loop.make_train_step(b["loss_fn"]))
    for _ in range(3):
        ma = eager(a["state"], a["batch"], a["tokens"])
        mb = graphed(b["state"], b["batch"], b["tokens"])
        for k in ma:
            torch.testing.assert_close(mb[k], ma[k], rtol=0, atol=0)
    assert graphed.graphs == {}
    assert a["state"].step == b["state"].step == 3
    assert (a["state"].optimizer.scheduler.last_epoch
            == b["state"].optimizer.scheduler.last_epoch == 3)
    for pa, pb in zip(a["model"].parameters(), b["model"].parameters()):
        torch.testing.assert_close(pb, pa, rtol=0, atol=0)

    step = loop.make_eval_step(a["loss_fn"], a["cfg"].mlp_class)
    want = step(a["model"], a["batch"], a["tokens"])
    got = graph.graphed(step)(a["model"], a["batch"], a["tokens"])
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    enc = b["encode"]
    assert isinstance(enc, graph.GraphedStep) and enc.graphs == {}
    images = torch.as_tensor(b["images"])
    torch.testing.assert_close(enc(images), enc.step(images), rtol=0,
                               atol=0)


# operations a CUDA graph cannot hold: a read of a value by the host, an
# output whose shape depends on the data, a tensor made from host data
_HOST_OPS = ("_local_scalar_dense", "nonzero", "unique", "masked_select",
             "bincount", "lift_fresh", "repeat_interleave")


class _HostOps(TorchDispatchMode):
    """Records each host-bound operation with the port's frame that asked
    for it. Left out: the kernels' plain versions and the CPU's optimizer
    (built without ``capturable``, which reads its step count on the
    host), which the card never runs."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        bool_index = name.startswith("index") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for a in args if isinstance(a, (list, tuple)) for i in a)
        if bool_index or any(op in name for op in _HOST_OPS):
            stack = traceback.extract_stack()
            frames = [f for f in stack if "tpu3dssf_torch" in f.filename]
            where = frames[-1] if frames else None
            plain = where is not None and (
                "/kernels/" in where.filename
                or where.name == "topk_neighbors_reference"
                or any("torch/optim/" in f.filename for f in stack))
            if not plain:
                self.found.append((name, where and (
                    f"{os.path.relpath(where.filename, ROOT)}:"
                    f"{where.lineno} {where.name}")))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("config", ["fusion", "lidar_parity"])
def test_steps_make_no_host_sync_and_no_host_copy(tmp_path, config):
    path = (_tiny_config(tmp_path) if config == "fusion"
            else _tiny_lidar_config(tmp_path))
    run = _tiny_run(path)
    eval_step = loop.make_eval_step(run["loss_fn"], run["cfg"].mlp_class)
    train_step = loop.make_train_step(run["loss_fn"])
    images = (None if run["encode"] is None
              else torch.as_tensor(run["images"]))
    # the first call of a step fills its device constants; the graph
    # captures the calls after it
    train_step(run["state"], run["batch"], run["tokens"])
    eval_step(run["model"], run["batch"], run["tokens"])
    with _HostOps() as mode:
        if images is not None:
            run["encode"](images)
        eval_step(run["model"], run["batch"], run["tokens"])
        train_step.update(run["state"], run["batch"], run["tokens"])
    assert mode.found == []


def test_host_op_recorder_sees_what_it_looks_for():
    x = torch.arange(6.0)
    with _HostOps() as mode:
        float(x.sum())
        x[x > 2]
        torch.tensor([1.0, 2.0])
    assert [n for n, _ in mode.found] == [
        "_local_scalar_dense.default", "index.Tensor", "lift_fresh.default"]


def test_counter_registry_names_every_launch_counter():
    names = {(m, n) for m, n in modules.COUNTERS.values()}
    for m in ("flash_attention", "window_attention", "knn"):
        module = getattr(modules, m)
        counters = {n for n in vars(module) if n.endswith("LAUNCHES")}
        assert counters == {n for mm, n in names if mm == m}, m
    before = modules.launch_counts()
    try:
        modules.set_launch_counts({"K4": before["K4"] + 5})
        assert modules.launch_counts() == dict(before, K4=before["K4"] + 5)
    finally:
        modules.set_launch_counts(before)


def test_a_restore_drops_the_graphs_over_the_state(tmp_path):
    """``TrainState.load_state_dict`` replaces the optimizer's state
    tensors, so the graphs captured over that state go; graphs over other
    objects stay."""
    run = _tiny_run(_tiny_config(tmp_path))
    state, model = run["state"], run["model"]
    step = loop.make_train_step(run["loss_fn"])
    step(state, run["batch"], run["tokens"])
    train = graph.graphed(step.update, "train_step")
    evaluate = graph.graphed(loop.make_eval_step(run["loss_fn"], 16))
    # stand-ins for captures, under the keys the wrapper would use
    train.graphs[("spec", (state, (2, 3)))] = "train graph"
    evaluate.graphs[("spec", (model, (2, 3)))] = "eval graph"
    state.load_state_dict(state.state_dict())
    assert train.graphs == {}
    assert list(evaluate.graphs.values()) == ["eval graph"]
