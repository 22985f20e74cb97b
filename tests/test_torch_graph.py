"""The CUDA-graph wrapper of the port's steps (``tpu3dssf_torch.train.
graph``) and what it needs of the steps, on the CPU.

On the CPU there are no graphs: a graphed step is the eager step, which
these tests hold bit for bit. What the card needs of a step to be captured
is checked here on CPU tensors: no host read (``.item()``, ``float()``,
``bool()``), no operation whose output shape depends on the data, and no
tensor made from host data inside the step (a graph cannot replay a
host-to-device copy), in the encode, eval and train steps of the fusion
and the LiDAR parity models, the train step under each setting that used
to keep it eager (ReduceLROnPlateau, skip_nonfinite, SGD with Nesterov
momentum, DropPath) and all four together. Then the metric sums, the
launch-counter registry and the dropping of graphs on a restore.
tests/test_torch_cuda.py holds the graphs themselves on the card.
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


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite's workers share the machine's cores, where a pool of threads per
    worker spends far longer waiting on its barriers than computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the train settings that each made a host decision in the update before
# they became device state, alone and together
SETTINGS = {
    "plateau": dict(lr_scheduler="ReduceLROnPlateau"),
    "skip": dict(skip_nonfinite=True),
    "sgd": dict(optimizer="SGD", momentum=0.9, nesterov=True),
    "drop_path": dict(drop_path=0.3),
}
SETTINGS["all"] = {k: v for s in SETTINGS.values() for k, v in s.items()}
DROPOUT_SEED = 42


def test_every_shipped_config_is_graphed():
    """Every config in configs/ trains through a graph on the card: its
    optimizer, schedule, clip and guard update a small parameter set
    without a host read or a host-made tensor."""
    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
    assert paths
    for path in paths:
        cfg = common.load_config(path)
        model = torch.nn.Linear(4, 3)
        state = common.init_state(cfg, model, steps_per_epoch=3)
        assert isinstance(graph.graph_train_step(
            loop.make_train_step(common.build_loss(cfg))),
            graph.GraphedStep)
        x, value = torch.ones(2, 4), torch.tensor(1.0)
        with _HostOps() as mode:
            for _ in range(2):
                model(x).sum().backward()
                state.apply_gradients(value=value)
        assert mode.found == [], path


def test_graphed_train_step_without_reason_splits_device_and_host(
        tmp_path, capsys):
    step = loop.make_train_step(common.build_loss(_cfg(tmp_path)))
    g = graph.graph_train_step(step)
    assert isinstance(g, graph.GraphedStep)
    assert g.step is step.update
    assert g.before is step.draw and g.after is step.advance
    assert "[graph]" not in capsys.readouterr().out


def _cfg(tmp_path, **train):
    cfg = common.load_config(_tiny_config(tmp_path))
    return dataclasses.replace(cfg, **train)


def _tiny_run(path, encode_tokens=True, **train):
    """The model, state, loss, eval step, encode fn and first train batch
    of the config at ``path`` (its train settings replaced by ``train``),
    on the CPU; the batch's patch tokens encoded, or zeros where not
    ``encode_tokens``."""
    cfg = dataclasses.replace(common.load_config(path), **train)
    cpu = torch.device("cpu")
    encode, vit_cfg = common.build_image_encoder(cfg, cpu)
    model, _ = common.build_pipeline(cfg, vit_cfg, cpu)
    state = common.init_state(cfg, model, steps_per_epoch=4)
    loss_fn = common.build_loss(cfg)
    host = next(iter(common.build_dataloaders(cfg)["train"]))
    images = host.pop("images", None)
    batch = common.batch_to_device(host, cpu)
    if encode is not None and encode_tokens:
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
    assert (int(a["state"].optimizer.count)
            == int(b["state"].optimizer.count) == 3)
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


def _train_step(run):
    seed = DROPOUT_SEED if run["cfg"].drop_path > 0 else None
    return loop.make_train_step(run["loss_fn"], seed)


CASES = [(c, s) for s in ["none"] + list(SETTINGS)
         for c in ("fusion", "lidar_parity")]


@pytest.mark.parametrize("config,setting", CASES, ids=[
    c if s == "none" else f"{c}-{s}" for c, s in CASES])
def test_steps_make_no_host_sync_and_no_host_copy(tmp_path, config,
                                                  setting):
    """The encode, eval and train steps; under each setting, the train
    step's device half (``update``), its masks drawn by its host half."""
    path = (_tiny_config(tmp_path) if config == "fusion"
            else _tiny_lidar_config(tmp_path))
    base = setting == "none"
    run = _tiny_run(path, encode_tokens=base, **SETTINGS.get(setting, {}))
    eval_step = loop.make_eval_step(run["loss_fn"], run["cfg"].mlp_class)
    train_step = _train_step(run)
    images = (None if run["encode"] is None
              else torch.as_tensor(run["images"]))
    # the first call of a step fills its device constants; the graph
    # captures the calls after it
    train_step(run["state"], run["batch"], run["tokens"])
    if base:
        eval_step(run["model"], run["batch"], run["tokens"])
    args = train_step.draw(run["state"], run["batch"], run["tokens"])
    assert (args[-1] is None) == (run["cfg"].drop_path == 0)
    with _HostOps() as mode:
        if base and images is not None:
            run["encode"](images)
        if base:
            eval_step(run["model"], run["batch"], run["tokens"])
        train_step.update(*args)
    assert mode.found == []


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_graphed_train_step_on_the_cpu_is_the_eager_step(tmp_path, setting):
    """Under each setting, two graphed train steps on the CPU (the eager
    step between the host halves) give the eager steps' bits: metrics,
    parameters, optimizer state and the chain's device state."""
    path = _tiny_lidar_config(tmp_path)
    a, b = (_tiny_run(path, **SETTINGS[setting]) for _ in range(2))
    eager = _train_step(a)
    graphed = graph.graph_train_step(_train_step(b))
    for _ in range(2):
        ma = eager(a["state"], a["batch"], a["tokens"])
        mb = graphed(b["state"], b["batch"], b["tokens"])
        for k in ma:
            torch.testing.assert_close(mb[k], ma[k], rtol=0, atol=0)
    assert graphed.graphs == {} and a["state"].step == b["state"].step == 2
    oa, ob = a["state"].optimizer, b["state"].optimizer
    assert int(oa.count) == 2
    for k, x in oa.device_state().items():
        torch.testing.assert_close(ob.device_state()[k], x, rtol=0, atol=0,
                                   msg=k)
    for pa, pb in zip(a["model"].parameters(), b["model"].parameters()):
        torch.testing.assert_close(pb, pa, rtol=0, atol=0)
        for k, x in oa.inner.state[pa].items():
            torch.testing.assert_close(ob.inner.state[pb][k], x, rtol=0,
                                       atol=0, msg=k)


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
    for m in ("flash_attention", "window_attention", "knn", "layer_norm"):
        module = getattr(modules, m)
        counters = {n for n in dir(module) if n.endswith("LAUNCHES")}
        assert counters == {n for mm, n in names if mm == m}, m
    before = modules.launch_counts()
    assert set(before) == set(modules.COUNTERS)
    try:
        modules.set_launch_counts({"K4": before["K4"] + 5,
                                   "LN": before["LN"] + 2})
        assert modules.launch_counts() == dict(
            before, K4=before["K4"] + 5, LN=before["LN"] + 2)
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
