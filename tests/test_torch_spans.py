"""The program's spans (``tpu3dssf_torch.utils.timing.span``) on the CPU.

Off, a span is one shared null context: no record, no CUDA event, no
profiler range. On, over a tiny fusion encode and forward, a LiDAR-only
eval step and a train step (eager, as on the CPU every step is): the
names, their parents, the frames they share, the self times, and the
outputs bit for bit as with spans off. ``GraphedStep``'s host ranges on the
CPU path, ``batch_to_device``'s counts, the counters, and a device read
that has to wait. Then ``probes/span_cells.py``'s idle split on hand-made
profiler rows. The card's side (event nodes in graphs, replayed spans) is
in ``tests/test_torch_cuda.py``.
"""

import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from tpu3dssf_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PTV3_CHILDREN = {"ptv3.serialize", "ptv3.pool", "ptv3.unpool",
                 "ptv3.blocks"}
FORWARD_CHILDREN = {"voxelize", "ptv3", "head", "devoxelize"}


@pytest.fixture(autouse=True)
def _spans_off_after():
    """One torch thread (tiny tensors), spans off and no records before
    and after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    timing.enable_spans(False)
    timing.reset_spans()
    yield
    timing.enable_spans(False)
    timing.reset_spans()
    torch.set_num_threads(n)


@contextlib.contextmanager
def spans_on():
    timing.enable_spans(True)
    timing.reset_spans()
    try:
        yield
    finally:
        timing.enable_spans(False)


def _pipeline_config():
    from tpu3dssf_torch.models import fusion, ptv3
    return fusion.PipelineConfig(
        fusion=fusion.FusionConfig(point_feat_dim=16, patch_tok_dim=16,
                                   hidden_dims=(16,), patch_size=8,
                                   encoder_size=(16, 24)),
        ptv3=ptv3.PTv3Config(
            enc_depths=(1, 1), enc_channels=(16, 32), enc_heads=(2, 2),
            enc_window=(64, 64), dec_depths=(1,), dec_channels=(16,),
            dec_heads=(2,), dec_window=(64,)),
        voxel_size=0.4, voxel_capacity=256)


def _batch(batch_size=2):
    from tpu3dssf_torch.cli.common import (HostDataPipeline,
                                           SyntheticNuScenes, batch_to_device)
    data = SyntheticNuScenes(num_samples=batch_size, num_points=600,
                             image_hw=(90, 160), seed=3)
    host = next(iter(HostDataPipeline(data, batch_size=batch_size,
                                      point_capacity=640)))
    images = torch.as_tensor(np.asarray(host.pop("images")))
    return batch_to_device(host, "cpu"), images


def _vit():
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.vit import VisionTransformer, ViTConfig
    cfg = ViTConfig(patch_size=8, image_size=(16, 24), hidden_size=16,
                    num_layers=1, num_heads=2)
    return init_weights(VisionTransformer(cfg), 1).eval(), cfg


def _model(lidar=False, seed=5):
    from tpu3dssf_torch.models.fusion import SegmentationPipeline
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.lidar_only import LidarSegmentationModel
    cls = LidarSegmentationModel if lidar else SegmentationPipeline
    return init_weights(cls(_pipeline_config()), seed)


def _loss():
    from tpu3dssf_torch.losses import CELSLoss
    return CELSLoss(weight=[1.0] * 16)


def _state(seed=5):
    from tpu3dssf_torch.train import TrainState, create_optimizer
    model = _model(seed=seed)
    return TrainState(model, create_optimizer(model.parameters(), "AdamW",
                                              1e-3, grad_clip=1.0))


def _encode_and_forward():
    from tpu3dssf_torch.train.loop import make_image_encode_fn
    vit, cfg = _vit()
    batch, images = _batch()
    model = _model().eval()
    encode = make_image_encode_fn(vit, cfg.image_size)
    with torch.no_grad():
        tokens = encode(images)
        logits = model(batch["points"], batch["point_valid"], tokens,
                       batch["cam_intrinsics"], batch["lidar2cam"])
    return tokens, logits


def _by_name(records):
    """{name: [(index, parent name, frame, ms)]} of span_records()."""
    out = {}
    for i, (name, parent, frame, clock, ms) in enumerate(records):
        assert clock == "host" and ms is not None and ms >= 0.0
        pname = None if parent is None else records[parent][0]
        out.setdefault(name, []).append((i, pname, frame, ms))
    return out


def _self_times_hold(records, summary):
    """Each name's self time is its time less its children's."""
    child = [0.0] * len(records)
    for name, parent, _, _, ms in records:
        if parent is not None:
            child[parent] += ms
    for name, s in summary.items():
        mine = [i for i, r in enumerate(records) if r[0] == name]
        assert s["count"] == len(mine)
        assert s["ms"] == pytest.approx(sum(records[i][4] for i in mine))
        assert s["self_ms"] == pytest.approx(
            sum(records[i][4] - child[i] for i in mine))
        assert s["frames"] == len({records[i][2] for i in mine})


def test_spans_off_are_one_null_context_and_record_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("spans off made an event or a range")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not timing.spans_enabled()
    a, b = timing.span("forward", torch.zeros(1)), timing.span("x")
    assert a is b and isinstance(a, contextlib.nullcontext)
    assert timing.frame() is a
    _encode_and_forward()
    assert timing.span_records() == []
    assert timing.span_summary() == {}
    assert timing.span_counters()["span_waits"] == 0


def test_fusion_encode_and_forward_spans():
    with spans_on():
        _encode_and_forward()
    records = timing.span_records()
    names = _by_name(records)
    assert set(names) == {"batch_to_device", "encode", "vit.preprocess",
                          "vit.blocks", "forward",
                          "ptv3"} | FORWARD_CHILDREN | PTV3_CHILDREN
    (enc,), (fwd,) = names["encode"], names["forward"]
    assert enc[1] is None and fwd[1] is None and enc[2] != fwd[2]
    for child in ("vit.preprocess", "vit.blocks"):
        assert [(p, f) for _, p, f, _ in names[child]] == [("encode",
                                                            enc[2])]
    for child in FORWARD_CHILDREN:
        assert [(p, f) for _, p, f, _ in names[child]] == [("forward",
                                                            fwd[2])]
    # PTv3 at two stages: one pooling, one unpooling, three block runs,
    # serialization at stage 0 and on the way out
    assert len(names["ptv3.pool"]) == len(names["ptv3.unpool"]) == 1
    assert len(names["ptv3.blocks"]) == 3
    assert len(names["ptv3.serialize"]) >= 2
    for child in PTV3_CHILDREN:
        assert {(p, f) for _, p, f, _ in names[child]} == {("ptv3",
                                                            fwd[2])}
    summary = timing.span_summary()
    _self_times_hold(records, summary)
    assert summary["forward"]["self_ms"] < summary["forward"]["ms"]


def test_lidar_eval_step_spans_share_the_step_frame():
    from tpu3dssf_torch.train.graph import graphed
    from tpu3dssf_torch.train.loop import make_eval_step
    step = graphed(make_eval_step(_loss(), 16), "eval_step")
    model = _model(lidar=True).eval()
    batch, _ = _batch()
    with spans_on():
        for _ in range(2):
            step(model, batch, None)
    records = timing.span_records()
    names = _by_name(records)
    assert set(names) == {"eager:eval_step", "forward", "loss",
                          "ptv3"} | FORWARD_CHILDREN | PTV3_CHILDREN
    calls = names["eager:eval_step"]
    assert len(calls) == 2 and calls[0][2] != calls[1][2]
    for root in ("forward", "loss"):
        got = [(p, f) for _, p, f, _ in names[root]]
        assert got == [("eager:eval_step", f) for _, _, f, _ in calls]
    assert {f for _, _, f, _ in names["ptv3.blocks"]} == {
        f for _, _, f, _ in calls}
    _self_times_hold(records, timing.span_summary())


def test_train_step_spans():
    from tpu3dssf_torch.train.graph import graph_train_step
    from tpu3dssf_torch.train.loop import make_train_step
    step = graph_train_step(make_train_step(_loss()))
    state = _state()
    batch, _ = _batch()
    tokens = torch.randn(2, 6, 6, 16, generator=torch.Generator()
                         .manual_seed(0))
    with spans_on():
        step(state, batch, tokens)
    records = timing.span_records()
    names = _by_name(records)
    assert set(names) == {"eager:train_step", "update", "forward", "loss",
                          "backward", "optimizer",
                          "ptv3"} | FORWARD_CHILDREN | PTV3_CHILDREN
    (call,) = names["eager:train_step"]
    assert [(p, f) for _, p, f, _ in names["update"]] == [
        ("eager:train_step", call[2])]
    for child in ("forward", "loss", "backward", "optimizer"):
        assert [(p, f) for _, p, f, _ in names[child]] == [("update",
                                                            call[2])]
    summary = timing.span_summary()
    _self_times_hold(records, summary)
    assert {s["frames"] for s in summary.values()} == {1}


def _train_run(on):
    from tpu3dssf_torch.train.loop import make_train_step
    state = _state(seed=7)
    batch, _ = _batch()
    tokens = torch.randn(2, 6, 6, 16, generator=torch.Generator()
                         .manual_seed(1))
    step = make_train_step(_loss())
    timing.enable_spans(on)
    try:
        m = [step(state, batch, tokens) for _ in range(2)]
    finally:
        timing.enable_spans(False)
    return ([p.detach().clone() for p in state.model.parameters()],
            [x["loss"] for x in m])


def test_outputs_are_bit_identical_with_spans_on_and_off():
    from tpu3dssf_torch.train.loop import make_eval_step
    runs = []
    for on in (False, True):
        timing.enable_spans(on)
        tokens, logits = _encode_and_forward()
        batch, _ = _batch()
        ev = make_eval_step(_loss(), 16)(_model(lidar=True).eval(), batch,
                                         None)
        timing.enable_spans(False)
        runs.append([tokens, logits, ev["loss"], ev["confusion"]])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    (p_off, l_off), (p_on, l_on) = _train_run(False), _train_run(True)
    assert all(torch.equal(a, b) for a, b in zip(p_off, p_on))
    assert all(torch.equal(a, b) for a, b in zip(l_off, l_on))


def test_graphed_step_host_ranges_on_the_cpu_path():
    from torch.profiler import ProfilerActivity, profile
    from tpu3dssf_torch.train.graph import graphed

    def step(x):
        with timing.span("inner", x):
            return x * 2

    g = graphed(step, "double")
    with spans_on(), profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            g(torch.ones(4))
        with timing.span("inner", torch.ones(1)):   # outside any call
            pass
    records = timing.span_records()
    calls = [r for r in records if r[0] == "eager:double"]
    inner = [r for r in records if r[0] == "inner"]
    assert len(calls) == 3 and len(inner) == 4
    assert [r[2] for r in inner[:3]] == [r[2] for r in calls]
    assert len({r[2] for r in records}) == 4        # one frame each
    assert inner[3][1] is None and inner[3][2] not in {r[2] for r in calls}
    ranges = [e for e in prof.events() if e.name.startswith("tpu3dssf::")]
    assert sorted({e.name for e in ranges}) == ["tpu3dssf::eager:double",
                                                "tpu3dssf::inner"]
    outer = [e.time_range for e in ranges
             if e.name == "tpu3dssf::eager:double"]
    assert len(outer) == 3
    within = [any(o.start <= e.time_range.start and e.time_range.end <= o.end
                  for o in outer)
              for e in ranges if e.name == "tpu3dssf::inner"]
    assert sorted(within) == [False, True, True, True]


def test_batch_to_device_range_counts_its_copies():
    from tpu3dssf_torch.cli.common import batch_to_device
    host = {"a": np.zeros((2, 3), np.float32), "b": np.ones(5, np.int64)}
    batch_to_device(host, "cpu")
    assert timing.span_counters().get("batch_to_device.tensors") is None
    with spans_on():
        batch_to_device(host, "cpu")
        batch_to_device(host, "cpu")
    c = timing.span_counters()
    assert c["batch_to_device.tensors"] == 4
    assert c["batch_to_device.bytes"] == 2 * (24 + 40)
    assert timing.span_summary()["batch_to_device"]["count"] == 2


def test_counters_restart_at_reset():
    with spans_on():
        assert timing.span_counters() == {"span_waits": 0}
        timing.count("graph_replays", 2)
        assert timing.span_counters()["graph_replays"] == 2
        timing.reset_spans()
        assert timing.span_counters() == {"span_waits": 0}
    timing.count("graph_replays")          # spans off: nothing counted
    assert "graph_replays" not in timing.span_counters()


def test_the_recorder_imports_no_layer_of_the_program():
    """``utils.timing`` sits under every layer that opens spans: it
    imports none of the port's other modules (they count into it)."""
    import subprocess
    import sys
    code = ("import sys, tpu3dssf_torch.utils.timing; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('tpu3dssf_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert eval(out.stdout) == ["tpu3dssf_torch", "tpu3dssf_torch.utils",
                                "tpu3dssf_torch.utils.timing"]


class _Event:
    """A stand-in for a CUDA event pair's end: not reached until waited
    for."""

    def __init__(self, done):
        self.done, self.waited = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True

    def elapsed_time(self, end):
        return 1.5


@pytest.mark.parametrize("done", [True, False])
def test_a_read_that_has_to_wait_counts(done):
    with spans_on():
        layout = [["a", None, _Event(True), _Event(done)],
                  ["b", 0, _Event(True), _Event(True)]]
        with timing.frame():
            recs = timing.replayed_spans(layout)
        timing.read_spans(recs)
        assert layout[0][3].waited == (not done)
        assert timing.span_counters()["span_waits"] == (0 if done else 1)
        summary = timing.span_summary()
    assert summary["a"] == {"clock": "device", "count": 1, "ms": 1.5,
                            "self_ms": 0.0, "frames": 1}
    assert summary["b"]["self_ms"] == 1.5
    assert timing.span_records()[1][1] == 0


def _probe():
    spec = importlib.util.spec_from_file_location(
        "span_cells", os.path.join(ROOT, "probes", "span_cells.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# a hand-made traced window (µs): two replays of graph "g" (launch
# correlation ids 7 and 9), a copy before each, and host ranges
HOST = [
    (0, 100, "bench::h2d", 1, 0),
    (5, 90, "tpu3dssf::batch_to_device", 2, 0),
    (100, 200, "bench::forward", 3, 0),
    (101, 150, "tpu3dssf::replay:g", 4, 0),
    (110, 112, "cudaGraphLaunch", 7, 4),
    (200, 300, "bench::to_host", 5, 0),
    (300, 400, "tpu3dssf::replay:g", 6, 0),
    (310, 311, "cudaGraphLaunch", 9, 6),
]
DEVICE = [            # (start, end, linked correlation id, id)
    (10, 20, 2, 21),                  # the copy
    (120, 130, 4, 7), (131, 140, 4, 7), (142, 150, 4, 7),   # replay 1
    (150, 160, 0, 8),                 # overlaps nothing: its own op
    (320, 330, 6, 9), (335, 340, 6, 9),                    # replay 2
]


@pytest.mark.parametrize("linked, spans", [(True, True), (False, True),
                                           (True, False)])
def test_idle_split_names_replay_gaps_and_keeps_the_total(linked, spans):
    mod = _probe()
    device = DEVICE if linked else [(s, e, 0, i) for s, e, _, i in DEVICE]
    host = HOST if spans else [h for h in HOST if "replay:" not in h[2]]
    split = mod.split_idle(device, host)
    if not spans:     # the launches named by the benchmark's ranges
        assert split["launch_s"] == {"replay:forward": pytest.approx(2e-6),
                                     "replay:?": pytest.approx(1e-6)}
        assert split["graph_gap_s"] == pytest.approx((1 + 2 + 5) * 1e-6)
        assert split["gaps"]["replay:forward"] == pytest.approx(3e-6)
        assert split["gaps"]["replay:?"] == pytest.approx(5e-6)
        return
    # the gaps between busy intervals: 20→120, 130→131, 140→142,
    # 160→320, 330→335; the idle total is the same however named
    assert sum(split["gaps"].values()) == pytest.approx(
        (100 + 1 + 2 + 160 + 5) * 1e-6)
    assert split["graph_gap_s"] == pytest.approx((1 + 2 + 5) * 1e-6)
    assert split["gaps"]["replay:g"] == pytest.approx(8e-6)
    # 20→120 at 70: the batch copy's range; 160→320 at 240: bench only
    assert split["gaps"]["batch_to_device"] == pytest.approx(100e-6)
    assert split["gaps"]["to_host"] == pytest.approx(160e-6)
    assert split["busy_s"] == pytest.approx((10 + 10 + 9 + 18 + 10 + 5)
                                            * 1e-6)
    assert split["launch_s"] == {"replay:g": pytest.approx(3e-6)}


class _Kineto:
    """A profiler's raw event: nanoseconds since the epoch."""

    class _Kind:
        def __init__(self, name):
            self.name = name

    def __init__(self, name, kind, start_ns, duration_ns, cid, link):
        self._v = (name, self._Kind(kind), start_ns, duration_ns, cid, link)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[0].startswith("tpu3dssf::")


def test_idle_split_rows_keep_gaps_under_a_microsecond():
    """The raw events' epoch nanoseconds, taken to µs from the first
    event: a 0.1 µs gap between two nodes of one replay survives."""
    mod = _probe()
    t = 1_792_358_218_265_479_794
    events = [_Kineto("tpu3dssf::replay:g", "CPU", t, 9_000, 3, 0),
              _Kineto("cudaGraphLaunch", "CPU", t + 1_000, 2_000, 7, 3),
              _Kineto("k1", "CUDA", t + 4_000, 1_000, 7, 3),
              _Kineto("k2", "CUDA", t + 5_100, 1_000, 7, 3)]
    device, host = mod.rows(events)
    assert device == [(4.0, 5.0, 3, 7), (5.1, 6.1, 3, 7)]
    assert host[0] == (0.0, 9.0, "tpu3dssf::replay:g", 3, 0)
    split = mod.split_idle(device, host)
    assert split["gaps"] == {"replay:g": pytest.approx(0.1e-6)}
    assert split["graph_gap_s"] == pytest.approx(0.1e-6)


def test_stage_metrics_per_frame_and_ratios():
    mod = _probe()
    spans = {n: {"ms": ms} for n, ms in (
        ("encode", 18.0), ("vit.preprocess", 6.0), ("forward", 20.0),
        ("voxelize", 2.0), ("ptv3", 14.0), ("ptv3.blocks", 10.0),
        ("ptv3.serialize", 1.0), ("ptv3.pool", 1.0), ("ptv3.unpool", 0.5),
        ("head", 1.5), ("devoxelize", 0.5), ("replay:encode", 2.0),
        ("replay:infer_labels", 1.0))}
    bench = {"vit_encode_ms.stream": {"value": 9.5},
             "pipeline_fwd_ms.stream": {"value": 10.5}}
    split = {"graph_gap_s": 0.01}
    out = mod.stage_metrics("stream", spans, 2, bench, split, 0.5)
    assert out["vit_preprocess_ms.stream"] == 3.0
    assert out["ptv3_resample_ms.stream"] == 1.25
    assert out["head_ms.stream"] == 1.0
    assert out["replay_enqueue_ms.stream"] == 1.5
    assert out["graph_gap_pct.stream"] == pytest.approx(2.0)
    assert out["ratio.encode"] == pytest.approx(9.0 / 9.5)
    assert out["ratio.forward"] == pytest.approx(10.0 / 10.5)
    assert out["forward_children_share"] == pytest.approx(0.9)
    assert "loss_ms.stream" not in out
