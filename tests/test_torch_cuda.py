"""The port's CUDA kernels (attention K1–K6, K8, K9, k-NN K7), a train step,
the CUDA graphs of the steps and the timers on the card (marked ``cuda``).

These tests need an NVIDIA GPU and nvcc; without a card each skips with
its reason. Run them on the card without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: bf16 kernel vs the plain version computing in f32 from the
same bf16 inputs, max abs error < 0.05 (bf16 output rounding plus the
bf16 probabilities of the PV product); LSE within 1e-3 on rows with a valid
key (f32 sums in another order); backward max |dqkv − plain| < 0.05 ·
max(1, max |plain|), the gradient rule of scripts/check_tpu_kernels.py
(bf16 p and ds in the products); dqkv exactly 0 in an all-padding window;
K7 bit-identical to its plain version (the same f32 operations in the same
order, no fused multiply-add on either side).
"""

import pytest
import torch

from tpu3dssf_torch.kernels import knn
from tpu3dssf_torch.kernels import window_attention_packed

# the modules (the package re-exports functions of the same names)
from tpu3dssf_torch.kernels.modules import flash_attention as fa
from tpu3dssf_torch.kernels.modules import window_attention as wa

pytestmark = pytest.mark.cuda
TOL = 0.05


def _lse(qkv, bias, H, q_scale, cos=None, sin=None):
    """The packed forward with its LSE through its op: K2 (C ≥ 128), K4,
    or with tables K1's RoPE branch."""
    C = qkv.shape[-1] // 3
    kernel = "K1" if cos is not None else "K2" if C % 128 == 0 else "K4"
    return torch.ops.tpu3dssf.packed_attention_lse(qkv, bias, H, q_scale,
                                                   cos, sin, kernel)


def _bwd(qkv, bias, dout, lse, delta, H, q_scale):
    """The packed backward through its op: K3 (C ≥ 128) or K5."""
    kernel = "K3" if (qkv.shape[-1] // 3) % 128 == 0 else "K5"
    return torch.ops.tpu3dssf.packed_attention_bwd(qkv, bias, dout, lse,
                                                   delta, H, q_scale, kernel)


def _flash_lse(q, k, v, bias, q_scale):
    """The (B, N, H, D) forward with its LSE through its op (K8)."""
    return torch.ops.tpu3dssf.attention_lse(q, k, v, bias, q_scale, "K8")


def _flash(q, k, v, bias, q_scale):
    """The (B, N, H, D) forward without LSE: through its op (K8) at the
    softmax scale 1/√D that the op takes, else through the packed op (K1),
    which takes any scale, on q, k, v packed into one (B, N, 3C)
    projection (head h at channel D h of each third)."""
    B, N, H, D = q.shape
    if q_scale == D ** -0.5:
        return torch.ops.tpu3dssf.attention(q, k, v, bias, None, "K8")
    qkv = torch.cat([x.reshape(B, N, H * D) for x in (q, k, v)], -1)
    out = torch.ops.tpu3dssf.packed_attention(qkv, bias, H, q_scale, None,
                                              None)
    return out.unflatten(-1, (H, D))


def _flash_bwd(q, k, v, bias, dout, lse, delta, q_scale):
    """The (B, N, H, D) backward through its op (K9)."""
    return torch.ops.tpu3dssf.attention_bwd(q, k, v, bias, dout, lse, delta,
                                            q_scale, "K9")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(cuda, B, N, C, masked, seed=0):
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, N, 3 * C, generator=gen).to(cuda, torch.bfloat16)
    keep = torch.rand(B, N, generator=gen) > (0.3 if masked else -1.0)
    if masked:
        keep[-1] = False
    bias = torch.where(keep, 0.0, -1e9)[:, None, :].to(cuda).contiguous()
    return qkv, bias


@pytest.mark.parametrize("B,N,C,H,q_scale,masked", [
    (3, 77, 384, 6, None, False),      # ViT-like, ragged N, pre-scaled q
    (2, 200, 128, 2, 0.125, False),    # D=64, ragged
    (4, 1024, 32, 2, 0.25, True),      # PTv3 C=32 window
    (3, 130, 512, 32, 0.25, True),     # many heads, ragged
    (1, 1, 16, 1, 0.25, False),        # one token
])
def test_kernel_matches_plain_version(cuda, B, N, C, H, q_scale, masked):
    qkv, bias = _inputs(cuda, B, N, C, masked)
    before = fa.LAUNCHES
    out = fa.flash_attention_packed(qkv, bias, H, q_scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref = fa.flash_attention_packed_reference(qkv, bias, H, q_scale)
    assert out.dtype == torch.bfloat16 and out.shape == (B, N, C)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() < TOL


def test_all_masked_window_is_a_finite_uniform_average(cuda):
    qkv, _ = _inputs(cuda, 2, 256, 32, False)
    bias = torch.full((2, 1, 256), -1e9, device=cuda)
    out = fa.flash_attention_packed(qkv, bias, 2, 0.25).float()
    v = qkv[..., 64:].float().mean(dim=1, keepdim=True)
    assert torch.isfinite(out).all()
    assert (out - v).abs().max().item() < TOL
    zeroed = window_attention_packed(qkv, torch.zeros(2, 256, dtype=torch.bool,
                                                      device=cuda), 2)
    assert zeroed.abs().max().item() == 0.0


def test_unsupported_inputs_raise(cuda):
    """The C++ kernel's checks raise RuntimeError, and nothing counts."""
    qkv, bias = _inputs(cuda, 1, 64, 96, False)
    before = fa.LAUNCHES
    with pytest.raises(RuntimeError, match="head dim"):
        fa.flash_attention_packed(qkv, bias, 3)            # D = 32
    with pytest.raises(RuntimeError, match="bfloat16"):
        fa.flash_attention_packed(qkv.float(), bias, 6)
    with pytest.raises(RuntimeError, match="contiguous"):
        fa.flash_attention_packed(qkv[:, ::2], bias, 6)
    with pytest.raises(RuntimeError, match="key_bias"):
        fa.flash_attention_packed(qkv, bias.double(), 6)
    assert fa.LAUNCHES == before


def test_profile_kernels_counts_the_kernel_launches(cuda):
    from tpu3dssf_torch.utils import cuda_ms, profile_kernels

    qkv, bias = _inputs(cuda, 4, 1024, 32, True)

    def two_calls():
        fa.flash_attention_packed(qkv, bias, 2, 0.25)
        fa.flash_attention_packed(qkv, bias, 2, 0.25)

    _, kernels, _ = profile_kernels(two_calls, reps=3)
    k1 = [v for k, v in kernels.items() if "fap_fwd_d16" in k]
    assert sum(n for _, n in k1) == 2
    assert sum(us for us, _ in k1) > 0
    assert cuda_ms(two_calls, reps=3, warmup=1) > 0


# ragged N and up to 32 heads, all at the PTv3 head dim D = 16
GRAD_SHAPES = [(3, 1, 32, 2), (2, 77, 64, 4), (3, 130, 128, 8),
               (4, 1024, 32, 2), (2, 1024, 512, 32)]


@pytest.mark.parametrize("B,N,C,H", GRAD_SHAPES)
def test_lse_kernel_matches_plain_version(cuda, B, N, C, H):
    qkv, bias = _inputs(cuda, B, N, C, masked=N > 1)
    out, lse = _lse(qkv, bias, H, (C // H) ** -0.5)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_packed_lse_reference(
        qkv, bias, H, (C // H) ** -0.5)
    assert lse.shape == (B, H, N) and lse.dtype == torch.float32
    assert (out.float() - ref.float()).abs().max().item() < TOL
    live = (bias[:, 0] == 0).any(-1)          # rows with a valid key
    assert (lse - ref_lse)[live].abs().max().item() < 1e-3


@pytest.mark.parametrize("B,N,C,H", GRAD_SHAPES)
def test_backward_kernel_matches_plain_version(cuda, B, N, C, H):
    q_scale = (C // H) ** -0.5
    qkv, bias = _inputs(cuda, B, N, C, masked=N > 1)
    keep = bias[:, 0] == 0
    gen = torch.Generator().manual_seed(1)
    dout = torch.randn(B, N, C, generator=gen).to(cuda)
    dout = (dout * keep[..., None]).to(torch.bfloat16)  # masked queries: 0
    out, lse = fa.flash_attention_packed_lse_reference(qkv, bias, H, q_scale)
    delta = fa.row_delta(dout, out * keep[..., None], H)
    got = _bwd(qkv, bias, dout, lse, delta, H, q_scale)
    torch.cuda.synchronize()
    ref = fa.flash_attention_packed_bwd_reference(qkv, bias, dout, lse,
                                                  delta, H, q_scale)
    assert got.shape == qkv.shape and torch.isfinite(got.float()).all()
    err = (got.float() - ref.float()).abs().max().item()
    assert err < TOL * max(1.0, ref.float().abs().max().item())
    if N > 1:   # the last row is an all-padding window
        assert got[-1].abs().max().item() == 0.0


def test_training_rules_launch_their_kernels(cuda):
    qkv, bias = _inputs(cuda, 3, 1024, 128, True)
    mask = bias[:, 0] == 0
    counts = (fa.LAUNCHES, fa.LSE_LAUNCHES, fa.BWD_LAUNCHES,
              wa.LSE_LAUNCHES, wa.BWD_LAUNCHES)
    x = qkv.detach().requires_grad_()
    fa.flash_attention_packed(x, bias, 8, 0.25).float().sum().backward()
    y = qkv[..., :96].contiguous().requires_grad_()
    window_attention_packed(y, mask, 2).float().sum().backward()
    torch.cuda.synchronize()
    after = (fa.LAUNCHES, fa.LSE_LAUNCHES, fa.BWD_LAUNCHES,
             wa.LSE_LAUNCHES, wa.BWD_LAUNCHES)
    assert [a - b for a, b in zip(after, counts)] == [0, 1, 1, 1, 1]
    assert torch.isfinite(x.grad.float()).all()
    assert y.grad[~mask].abs().max().item() == 0.0   # masked slots
    with pytest.raises(RuntimeError, match="head dim"):   # D = 32: none
        z = qkv[..., :192].contiguous().requires_grad_()
        fa.flash_attention_packed(z, bias, 2, 0.125).sum().backward()


def _small_model(cuda, batch_size=2, seed=6, drop_path=0.0, name="AdamW",
                 **opt):
    """A small bf16 fusion pipeline (PTv3 at C = 32 and 128, window 128:
    K2–K5 in training; DropPath at ``drop_path``) with seeded weights, its
    optimizer state (``name`` and ``opt`` to ``create_optimizer``), loss
    and one batch with random tokens: (state, loss_fn, batch, tokens)."""
    from tpu3dssf_torch.cli.common import (HostDataPipeline,
                                           SyntheticNuScenes, batch_to_device)
    from tpu3dssf_torch.losses import CELSLoss
    from tpu3dssf_torch.models import fusion, ptv3
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.train import TrainState, create_optimizer

    bf16 = torch.bfloat16
    cfg = fusion.PipelineConfig(
        fusion=fusion.FusionConfig(point_feat_dim=32, patch_tok_dim=16,
                                   patch_size=8, encoder_size=(48, 80),
                                   dtype=bf16),
        ptv3=ptv3.PTv3Config(
            enc_depths=(1, 1), enc_channels=(32, 128), enc_heads=(2, 8),
            enc_window=(128, 128), dec_depths=(1,), dec_channels=(32,),
            dec_heads=(2,), dec_window=(128,), drop_path=drop_path,
            dtype=bf16),
        voxel_size=0.4, voxel_capacity=1024)
    data = SyntheticNuScenes(num_samples=batch_size, num_points=3000,
                             image_hw=(90, 160), seed=3)
    host = next(iter(HostDataPipeline(data, batch_size=batch_size,
                                      point_capacity=3072)))
    host.pop("images")
    batch = batch_to_device(host, cuda)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randn(batch_size, 6, 60, 16, generator=gen).to(cuda, bf16)
    model = init_weights(fusion.SegmentationPipeline(cfg), seed).to(cuda)
    state = TrainState(model, create_optimizer(
        model.parameters(), name, 1e-3, grad_clip=1.0, **opt))
    return state, CELSLoss(weight=[1.0] * 16), batch, tokens


def test_small_model_train_step_on_the_card(cuda):
    from tpu3dssf_torch.train import make_train_step

    state, loss_fn, batch, tokens = _small_model(cuda)
    step = make_train_step(loss_fn)
    before = (fa.LSE_LAUNCHES, fa.BWD_LAUNCHES, wa.LSE_LAUNCHES,
              wa.BWD_LAUNCHES)
    m = step(state, batch, tokens)
    torch.cuda.synchronize()
    after = (fa.LSE_LAUNCHES, fa.BWD_LAUNCHES, wa.LSE_LAUNCHES,
             wa.BWD_LAUNCHES)
    assert all(a > b for a, b in zip(after, before))
    assert torch.isfinite(m["loss"]).item()
    for p in state.model.parameters():
        assert torch.isfinite(p).all()


def _max_diff(a, b):
    return max((x.double() - y.double()).abs().max().item()
               for x, y in zip(a, b))


def _bit_exact(graph_diff, eager_diff):
    """Graphed vs eager, and eager vs eager: the same bits (chip_smoke.py's
    rule for a graphed step: the eager step is bit-reproducible)."""
    return graph_diff == 0.0 and eager_diff == 0.0


def _within_eager(graph_diff, eager_diff):
    """A loaded program vs the eager model: bit-identical where two eager
    runs are, else within 2x their difference (chip_smoke.py's rule for
    phase 25)."""
    if eager_diff == 0.0:
        return graph_diff == 0.0
    return graph_diff <= 2.0 * eager_diff


def _launches(fn):
    from tpu3dssf_torch.kernels import modules
    before = modules.launch_counts()
    fn()
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in modules.launch_counts().items()
            if v != before[k]}


def test_graphed_eval_step_matches_eager(cuda):
    from tpu3dssf_torch.train import graph, make_eval_step

    state, loss_fn, batch, tokens = _small_model(cuda)
    step = make_eval_step(loss_fn, 16)
    g = graph.graphed(step)
    eager = [step(state.model, batch, tokens) for _ in range(3)]
    graphed = [g(state.model, batch, tokens) for _ in range(4)]
    assert len(g.graphs) == 1
    for k in eager[0]:
        e = max(_max_diff([x[k]], [eager[0][k]]) for x in eager[1:])
        d = max(_max_diff([x[k]], [eager[0][k]]) for x in graphed)
        assert _bit_exact(d, e), (k, d, e)
    # fresh outputs: a later replay leaves an earlier result as it was
    assert graphed[1]["confusion"].data_ptr() != \
        graphed[2]["confusion"].data_ptr()


def test_graphed_train_call_is_one_eager_call(cuda):
    """The first graphed call is the eager step, and its capture updates
    nothing: one graphed call gives one eager call's parameters, update
    count and Adam step."""
    from tpu3dssf_torch.train import graph, make_train_step

    runs = []
    for graphed in (True, False, False):
        state, loss_fn, batch, tokens = _small_model(cuda)
        step = make_train_step(loss_fn)
        if graphed:
            step = graph.graph_train_step(step)
        step(state, batch, tokens)
        torch.cuda.synchronize()
        if graphed:
            assert len(step.graphs) == 1
        adam = {int(s["step"]) for s in state.optimizer.inner.state.values()}
        runs.append(([p.detach().clone() for p in state.model.parameters()],
                     state.step, adam))
    (pg, ng, ag), (pe, ne, ae), (pe2, _, _) = runs
    assert ng == ne == 1 and ag == ae == {1}
    assert _bit_exact(_max_diff(pg, pe), _max_diff(pe2, pe))


def test_graph_replays_count_the_eager_launches(cuda):
    """N replays add N times the eager step's launches to the counters
    (the capture adds none)."""
    from tpu3dssf_torch.train import graph, make_eval_step, make_train_step

    state, loss_fn, batch, tokens = _small_model(cuda)
    for step, g in ((make_eval_step(loss_fn, 16), None),
                    (make_train_step(loss_fn), "train")):
        graphed = (graph.graph_train_step(step) if g else
                   graph.graphed(step))
        args = (state if g else state.model, batch, tokens)
        eager = _launches(lambda: step(*args))
        assert eager and _launches(lambda: graphed(*args)) == eager
        assert _launches(lambda: [graphed(*args) for _ in range(3)]) == \
            {k: 3 * v for k, v in eager.items()}


def test_a_new_shape_captures_a_second_graph(cuda):
    from tpu3dssf_torch.train import graph, make_eval_step

    state, loss_fn, batch, tokens = _small_model(cuda)
    step = make_eval_step(loss_fn, 16)
    g = graph.graphed(step)
    g(state.model, batch, tokens)
    one = {k: v[:1] for k, v in batch.items()}
    eager = _launches(lambda: step(state.model, one, tokens[:1]))
    g(state.model, one, tokens[:1])
    assert len(g.graphs) == 2
    captures = graph.CAPTURES
    assert _launches(lambda: g(state.model, one, tokens[:1])) == eager
    assert graph.CAPTURES == captures
    want = step(state.model, one, tokens[:1])
    got = g(state.model, one, tokens[:1])
    assert int(got["valid"]) == int(want["valid"])


def test_a_restore_drops_the_graphs_and_captures_anew(cuda):
    from tpu3dssf_torch.train import graph, make_train_step

    state, loss_fn, batch, tokens = _small_model(cuda)
    g = graph.graph_train_step(make_train_step(loss_fn))
    g(state, batch, tokens)
    saved = state.state_dict()
    g(state, batch, tokens)
    assert len(g.graphs) == 1
    state.load_state_dict(saved)
    assert g.graphs == {} and state.step == 1
    captures = graph.CAPTURES
    m = g(state, batch, tokens)
    assert graph.CAPTURES == captures + 1 and len(g.graphs) == 1
    assert torch.isfinite(m["loss"]).item() and state.step == 2
    lr = state.optimizer.inner.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.device.type == "cuda"


def test_graphs_share_a_pool_and_outlive_their_predecessors(cuda):
    """Captures while a graph lives share its memory pool; once every graph
    is gone (and the allocator still holds the pool's blocks), a new
    capture takes a new pool, as a second main_train run in one process
    does."""
    from tpu3dssf_torch.train import graph, make_eval_step

    state, loss_fn, batch, tokens = _small_model(cuda)
    step = make_eval_step(loss_fn, 16)
    a, b = graph.graphed(step), graph.graphed(step)
    a(state.model, batch, tokens)
    b(state.model, batch, tokens)
    (ga,), (gb,) = a.graphs.values(), b.graphs.values()
    assert ga.graph.pool() == gb.graph.pool()
    del a, b, ga, gb
    c = graph.graphed(step)
    want = step(state.model, batch, tokens)
    c(state.model, batch, tokens)
    got = c(state.model, batch, tokens)
    assert int(got["valid"]) == int(want["valid"])


def test_the_tensor_lr_follows_the_schedule_across_replays(cuda):
    """A cosine schedule over 6 updates: after every graphed step the rate
    on the card is the schedule's, and 5 graphed steps give 5 eager steps'
    parameters (a rate baked in at capture would not)."""
    from tpu3dssf_torch.train import create_schedule, graph, make_train_step

    kw = dict(lr_scheduler="CosineAnnealingLR", steps_per_epoch=6,
              num_epochs=1)
    runs = []
    for graphed in (True, False, False):
        state, loss_fn, batch, tokens = _small_model(cuda, **kw)
        step = make_train_step(loss_fn)
        if graphed:
            step = graph.graph_train_step(step)
        opt = state.optimizer
        sched = create_schedule("CosineAnnealingLR", 6, 1)
        for i in range(5):
            step(state, batch, tokens)
            # the rate update i took, and the one the next takes
            for lr, c in ((opt.inner.param_groups[0]["lr"], i),
                          (opt.rate(), i + 1)):
                want = torch.tensor(1e-3 * sched(c), dtype=torch.float32)
                assert float(lr) == float(want)
        runs.append([p.detach().clone() for p in state.model.parameters()])
    assert _bit_exact(_max_diff(runs[0], runs[1]),
                      _max_diff(runs[2], runs[1]))


# The program's spans in CUDA graphs (tpu3dssf_torch.utils.timing): off,
# a capture holds what it held before spans existed; on, the same kernel
# nodes plus two event-record nodes a span, read after every replay.
def _node_labels(g):
    """A graph's node labels with every number taken out (pointers, node
    ids and launch sizes differ between two captures of one step)."""
    import re
    (captured,) = g.graphs.values()
    return [re.sub(r"0x[0-9a-fA-F]+|\d+", "", body)
            for body in captured.nodes if "shape=" in body]   # no edges


def _is_event(label):
    return "EVENT" in label.upper()


def _with_spans(on, fn):
    from tpu3dssf_torch.utils import timing
    timing.enable_spans(on)
    timing.reset_spans()
    try:
        return fn()
    finally:
        timing.enable_spans(False)


def _labels_step(model, batch, tokens):
    return model(batch["points"], batch["point_valid"], tokens,
                 batch["cam_intrinsics"], batch["lidar2cam"]).argmax(-1)


@pytest.mark.parametrize("kind", ["labels", "eval", "train"])
def test_spans_add_only_event_nodes_to_a_graph(cuda, kind):
    from tpu3dssf_torch.train import graph, make_eval_step, make_train_step

    labels = {}
    for on in (False, True):
        state, loss_fn, batch, tokens = _small_model(cuda)
        if kind == "train":
            g = graph.graphed(make_train_step(loss_fn).update, nodes=True)
            args = (state, batch, tokens)
        else:
            step = (_labels_step if kind == "labels"
                    else make_eval_step(loss_fn, 16))
            g = graph.graphed(torch.inference_mode()(step), nodes=True)
            args = (state.model, batch, tokens)
        _with_spans(on, lambda: g(*args))
        labels[on] = _node_labels(g)
        if on:
            (captured,) = g.graphs.values()
            spans = captured.spans
    from collections import Counter
    assert labels[False] and not any(map(_is_event, labels[False]))
    events = [x for x in labels[True] if _is_event(x)]
    on = Counter(x for x in labels[True] if not _is_event(x))
    off = Counter(labels[False])
    assert on == off, (list(on - off)[:2], list(off - on)[:2])
    names = {name for name, _, _, _ in spans}
    want = {"forward", "voxelize", "ptv3", "head", "devoxelize",
            "ptv3.blocks", "ptv3.serialize", "ptv3.pool", "ptv3.unpool"}
    want |= {"eval": {"loss"}, "train": {"update", "loss", "backward",
                                         "optimizer"}}.get(kind, set())
    assert names == want and len(events) == 2 * len(spans)


def test_replayed_spans_read_positive_times_children_inside_parents(cuda):
    from tpu3dssf_torch.train import graph
    from tpu3dssf_torch.utils import timing

    state, loss_fn, batch, tokens = _small_model(cuda)
    g = graph.graphed(torch.inference_mode()(_labels_step), "labels")

    def run():
        for _ in range(3):
            g(state.model, batch, tokens)
        torch.cuda.synchronize()
        (captured,) = g.graphs.values()
        inside = all(
            captured.spans[p][2].elapsed_time(start) >= 0.0
            and end.elapsed_time(captured.spans[p][3]) >= 0.0
            for _, p, start, end in captured.spans if p is not None)
        return inside, timing.span_records(), timing.span_summary()

    inside, records, summary = _with_spans(True, run)
    assert inside
    device = [r for r in records if r[3] == "device"]
    # the eager first call's spans and two replays' of the same layout
    assert {r[2] for r in device} == {r[2] for r in records
                                      if r[0].startswith(("capture:",
                                                          "replay:"))}
    assert summary["forward"]["count"] == 3
    assert summary["forward"]["frames"] == 3
    assert summary["replay:labels"]["count"] == 2
    assert summary["replay:labels"]["clock"] == "host"
    for name, parent, frame, clock, ms in device:
        assert ms > 0.0, name
        if parent is not None:
            assert records[parent][2] == frame
            assert ms <= records[parent][4] + 1e-3, (name, records[parent])
    assert summary["forward"]["self_ms"] >= -1e-3


def test_spans_leave_labels_and_the_train_update_bit_identical(cuda):
    from tpu3dssf_torch.train import graph, make_train_step

    got = {}
    for on in (False, True):
        state, loss_fn, batch, tokens = _small_model(cuda, drop_path=0.3)
        labels = graph.graphed(torch.inference_mode()(_labels_step))
        train = graph.graph_train_step(make_train_step(loss_fn, 7))

        def run():
            out = [labels(state.model, batch, tokens) for _ in range(3)]
            for _ in range(3):
                train(state, batch, tokens)
            torch.cuda.synchronize()
            return out

        out = _with_spans(on, run)
        got[on] = (out, [p.detach().clone()
                         for p in state.model.parameters()])
    for a, b in zip(got[False][0], got[True][0]):
        assert torch.equal(a, b)
    assert _max_diff(got[False][1], got[True][1]) == 0.0


def test_span_reads_wait_for_nothing_in_a_loop_with_a_blocking_copy(cuda):
    """The loops' order (a blocking copy of the batch, then the replay)
    leaves every read of the last replay's spans to events already
    reached; replays enqueued back to back make the reads wait."""
    from tpu3dssf_torch.cli.common import batch_to_device
    from tpu3dssf_torch.train import graph
    from tpu3dssf_torch.utils import timing

    state, loss_fn, batch, tokens = _small_model(cuda)
    host = {k: v.cpu().numpy() for k, v in batch.items()}
    g = graph.graphed(torch.inference_mode()(_labels_step), "labels")

    def loop(copy):
        g(state.model, batch, tokens)
        timing.reset_spans()
        for _ in range(10):
            b = batch_to_device(host, cuda) if copy else batch
            g(state.model, b, tokens)
        return timing.span_counters()

    counters = _with_spans(True, lambda: loop(True))
    assert counters["span_waits"] == 0 and counters["graph_replays"] == 10
    assert counters["batch_to_device.tensors"] == 10 * len(host)
    assert _with_spans(True, lambda: loop(False))["span_waits"] > 0


@pytest.mark.parametrize("setting", ["plateau", "skip", "sgd",
                                     "drop_path", "all"])
def test_every_train_setting_replays_its_eager_step(cuda, setting):
    """Under each setting that once kept the step eager (chip_smoke's
    SETTINGS), the graphed step launches what the eager one does per
    replay, and 3 graphed steps from one state give 3 eager steps'
    parameters bit for bit (chip_smoke's rule), with the same chain state.
    The optimizer is SGD where the setting leaves it open (chip_smoke phase
    29 holds the AdamW settings at full width)."""
    import chip_smoke
    from tpu3dssf_torch.train import graph, make_train_step

    kw = dict(chip_smoke.SETTINGS[setting])
    kw["name"] = kw.pop("optimizer", "SGD")
    state, loss_fn, batch, tokens = _small_model(cuda, steps_per_epoch=2,
                                                 **kw)
    step = make_train_step(loss_fn, 7 if kw.get("drop_path") else None)
    g_step = graph.graph_train_step(step)
    g_step(state, batch, tokens)                     # eager call + capture
    eager = _launches(lambda: step(state, batch, tokens))
    assert eager and _launches(lambda: g_step(state, batch, tokens)) == eager
    row = chip_smoke.hold_train_runs(setting, state, g_step, step,
                                     (batch, tokens))
    [(updates, trace)] = row["counts"]
    assert updates == state.step and trace[-1]["count"] == state.step
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def _bhnd_inputs(cuda, B, N, H, D, seed=0):
    """q, k, v as (B, N, H, D) views of one bf16 (B, N, 3C) buffer (the
    strides the models hand the kernels), a bias masking the last 5 keys
    (JAX's test_attention.py bias) and an upstream gradient."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, N, 3 * H * D, generator=gen).to(cuda, torch.bfloat16)
    q, k, v = qkv.unflatten(-1, (3, H, D)).unbind(2)
    bias = torch.zeros(B, 1, N)
    if N > 5:
        bias[:, :, -5:] = -1e9
    dout = torch.randn(B, N, H, D, generator=gen).to(cuda, torch.bfloat16)
    return q, k, v, bias.to(cuda), dout


def _grads_close(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a.float()).all()
        err = (a.float() - b.float()).abs().max().item()
        assert err < TOL * max(1.0, b.float().abs().max().item())


# ragged N and the ViT-L encoder's shape (D = 64, 16 heads), and D = 16
FLASH_SHAPES = [(2, 1, 16, 64), (2, 77, 16, 64), (2, 130, 16, 64),
                (1, 2845, 16, 64), (3, 130, 4, 16), (2, 77, 2, 16)]


@pytest.mark.parametrize("B,N,H,D", FLASH_SHAPES)
def test_flash_kernels_match_their_plain_versions(cuda, B, N, H, D):
    """K8 (and its training forward with LSE) and K9 vs their plain
    versions on the same bf16 inputs."""
    q, k, v, bias, dout = _bhnd_inputs(cuda, B, N, H, D)
    before = fa.FLASH_LAUNCHES
    out = fa.flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa.FLASH_LAUNCHES == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (B, N, H, D)
    ref = fa.mha_reference(q, k, v, bias)
    assert (out.float() - ref.float()).abs().max().item() < TOL
    scale = D ** -0.5
    out, lse = _flash_lse(q, k, v, bias, scale)
    ref, ref_lse = fa.flash_attention_lse_reference(q, k, v, bias, scale)
    assert (out.float() - ref.float()).abs().max().item() < TOL
    assert (lse - ref_lse).abs().max().item() < 1e-3
    delta = fa.row_delta(dout, out)
    got = _flash_bwd(q, k, v, bias, dout, lse, delta, scale)
    torch.cuda.synchronize()
    _grads_close(got, fa.flash_attention_bwd_reference(
        q, k, v, bias, dout, lse, delta, scale))


@pytest.mark.parametrize("W,K,H", [(64, 48, 2), (12, 48, 32), (5, 77, 4)])
def test_window_route_matches_its_plain_versions(cuda, W, K, H):
    """K6, and the K4/K5 rule through autograd, on (W, K, H, D) views with
    random padding keys and an all-padding last window: outputs vs
    ``window_attention_reference``, gradients vs its autograd in f32,
    exactly 0 in the all-padding window."""
    q, k, v, _, dout = _bhnd_inputs(cuda, W, K, H, 16)
    gen = torch.Generator().manual_seed(2)
    mask = torch.rand(W, K, generator=gen) > 0.3
    mask[-1] = False
    mask = mask.to(cuda)
    counts = (wa.LAUNCHES, wa.LSE_LAUNCHES, wa.BWD_LAUNCHES)
    out = wa.window_attention(q, k, v, mask)
    ref = wa.window_attention_reference(q, k, v, mask)
    assert (out.float() - ref.float()).abs().max().item() < TOL
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    wa.window_attention(*leaves, mask).backward(dout)
    torch.cuda.synchronize()
    assert (wa.LAUNCHES, wa.LSE_LAUNCHES, wa.BWD_LAUNCHES) == tuple(
        c + 1 for c in counts)
    f32 = [x.detach().float().requires_grad_() for x in (q, k, v)]
    wa.window_attention_reference(*f32, mask).backward(dout.float())
    _grads_close([x.grad for x in leaves], [x.grad for x in f32])
    assert max(x.grad[-1].abs().max().item() for x in leaves) == 0.0


def test_flash_attention_rule_launches_k8_and_k9(cuda):
    """The training rule of ``flash_attention``: one K8 (with LSE) forward
    and one K9 backward; gradients vs autograd of ``mha_reference`` in
    f32."""
    q, k, v, bias, dout = _bhnd_inputs(cuda, 2, 300, 16, 64)
    counts = (fa.FLASH_LAUNCHES, fa.FLASH_BWD_LAUNCHES, fa.LAUNCHES)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*leaves, bias).backward(dout)
    torch.cuda.synchronize()
    assert (fa.FLASH_LAUNCHES, fa.FLASH_BWD_LAUNCHES, fa.LAUNCHES) == (
        counts[0] + 1, counts[1] + 1, counts[2])
    f32 = [x.detach().float().requires_grad_() for x in (q, k, v)]
    fa.mha_reference(*f32, bias).backward(dout.float())
    _grads_close([x.grad for x in leaves], [x.grad for x in f32])


def test_flash_kernels_refuse_what_they_do_not_take(cuda):
    """The C++ kernels' checks raise RuntimeError, and nothing counts."""
    before = (fa.FLASH_LAUNCHES, fa.FLASH_BWD_LAUNCHES)
    q, k, v, bias, dout = _bhnd_inputs(cuda, 1, 64, 2, 32)     # D = 32
    with pytest.raises(RuntimeError, match="head dim"):
        _flash_lse(q, k, v, bias, 0.2)
    q, k, v, bias, dout = _bhnd_inputs(cuda, 1, 64, 2, 16)
    with pytest.raises(RuntimeError, match="bias"):
        _flash_lse(q, k, v, bias.cpu(), 0.25)
    with pytest.raises(RuntimeError, match="bfloat16"):
        _flash_lse(q.float(), k.float(), v.float(), bias, 0.25)
    strided = torch.zeros(1, 64, 2, 32, device=cuda,
                          dtype=torch.bfloat16)[..., ::2]   # D stride 2
    with pytest.raises(RuntimeError, match="contiguous"):
        _flash_lse(strided, k, v, bias, 0.25)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(RuntimeError, match="bfloat16"):
        _flash_bwd(q, k, v, bias, dout.float(), lse, lse, 0.25)
    with pytest.raises(RuntimeError, match="lse"):
        _flash_bwd(q, k, v, bias, dout, lse[:, :1], lse, 0.25)
    assert (fa.FLASH_LAUNCHES, fa.FLASH_BWD_LAUNCHES) == before


def _knn_inputs(cuda, B, Q, R, masked=0.2, seed=0):
    """Points over a 120 m square, as the synthetic scenes span: |q|² up to
    7200, where one f32 ulp is as large as a neighbour gap at 0.1 m."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.rand(B, Q, 3, generator=gen) * 120 - 60
    r = torch.rand(B, R, 3, generator=gen) * 120 - 60
    r[:, 10:20] = r[:, :10]                  # exact ties
    m = torch.rand(B, R, generator=gen) > masked
    return q.to(cuda), r.to(cuda), m.to(cuda)


# besides, shapes off K7's blocks, at every k: a unit of 512 queries (1024
# at k = 1) and a tile of 512 refs; the plan cuts the work into as many
# runs as the card holds blocks, so these give units of one segment and
# of several (merged)
@pytest.mark.parametrize("B,Q,R,k", [(2, 77, 200, 1), (3, 1000, 2501, 5),
                                     (1, 4097, 1031, 8), (2, 257, 64, 5)] + [
    (B, Q, R, k) for B, Q, R in ((2, 1500, 5000), (1, 4097, 1031),
                                 (3, 700, 513), (4, 9000, 20000))
    for k in range(1, 9)])
def test_knn_kernel_is_bit_identical_to_its_plain_version(cuda, B, Q, R, k):
    from tpu3dssf_torch.voxel.voxelize import topk_neighbors_reference

    q, r, m = _knn_inputs(cuda, B, Q, R)
    before = knn.LAUNCHES
    d, i = knn.knn(q, r, m, k)
    torch.cuda.synchronize()
    assert knn.LAUNCHES == before + 1
    want_d, want_i = topk_neighbors_reference(q, r, m, k)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert d.shape == i.shape == (B, Q, k)
    assert torch.equal(d, want_d) and torch.equal(i, want_i)


def test_knn_kernel_fills_missing_neighbours_with_bad_slots(cuda):
    from tpu3dssf_torch.voxel.voxelize import topk_neighbors_reference

    q, r, _ = _knn_inputs(cuda, 2, 100, 40)
    m = torch.zeros(2, 40, dtype=torch.bool, device=cuda)
    m[1, [3, 17, 29]] = True                 # sample 0: no valid ref
    d, i = knn.knn(q, r, m, 5)
    want_d, want_i = topk_neighbors_reference(q, r, m, 5)
    assert torch.equal(d, want_d) and torch.equal(i, want_i)
    assert (d[0] == knn.BAD_DIST).all() and (i[0] == 0).all()
    assert (d[1, :, 3:] == knn.BAD_DIST).all() and (i[1, :, 3:] == 0).all()


def test_knn_kernel_refuses_what_it_does_not_take(cuda):
    q, r, m = _knn_inputs(cuda, 1, 10, 20)
    with pytest.raises(ValueError, match="k"):
        knn.knn(q, r, m, 9)
    with pytest.raises(TypeError, match="float32"):
        knn.knn(q.double(), r, m, 3)
    with pytest.raises(ValueError, match="ref_mask"):
        knn.knn(q, r, m.float(), 3)


def test_graphed_lidar_train_step_with_knn5_and_nearest(cuda):
    """A small bf16 LiDAR-only model in the parity modes (knn5 intensities,
    nearest devoxelization), K7 inside the captured train step beside
    K2–K5: exact launches per replay (a forward with LSE and a backward a
    block: K2/K3 at C = 128, K4/K5 at C = 32; K7 twice), and 3 graphed
    steps from one state against eager ones, restored in place, every
    parameter held as chip_smoke.py holds them
    (``chip_smoke.hold_train_runs``)."""
    import chip_smoke

    from tpu3dssf_torch.cli.common import (HostDataPipeline,
                                           SyntheticNuScenes, batch_to_device)
    from tpu3dssf_torch.losses import CELSLoss
    from tpu3dssf_torch.models import fusion, lidar_only, ptv3
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.train import (TrainState, create_optimizer, graph,
                                      make_train_step)

    bf16 = torch.bfloat16
    cfg = fusion.PipelineConfig(
        fusion=fusion.FusionConfig(output_dim=16, dtype=bf16),
        ptv3=ptv3.PTv3Config(
            enc_depths=(1, 1), enc_channels=(32, 128), enc_heads=(2, 8),
            enc_window=(128, 128), dec_depths=(1,), dec_channels=(32,),
            dec_heads=(2,), dec_window=(128,), dtype=bf16),
        voxel_size=0.4, voxel_capacity=1024, intensity_mode="knn5",
        devoxelize_mode="nearest")
    data = SyntheticNuScenes(num_samples=2, num_points=3000,
                             image_hw=(90, 160), seed=3)
    host = next(iter(HostDataPipeline(data, batch_size=2,
                                      point_capacity=3072)))
    host.pop("images")
    batch = batch_to_device(host, cuda)
    tokens = torch.zeros(2, 1, 1, 1, device=cuda)
    model = init_weights(lidar_only.LidarSegmentationModel(cfg), 6).to(cuda)
    state = TrainState(model, create_optimizer(
        model.parameters(), "AdamW", 1e-3, weight_decay=1e-3,
        lr_scheduler="CosineAnnealingLR", steps_per_epoch=12, num_epochs=30,
        grad_clip=1.0))
    step = make_train_step(CELSLoss(weight=[1.0] * 16))
    g_step = graph.graph_train_step(step)
    g_step(state, batch, tokens)                     # eager call + capture
    want = {"K2": 1, "K3": 1, "K4": 2, "K5": 2, "K7": 2}
    assert _launches(lambda: step(state, batch, tokens)) == want
    assert _launches(lambda: g_step(state, batch, tokens)) == want
    assert _launches(lambda: [g_step(state, batch, tokens)
                              for _ in range(3)]) == \
        {k: 3 * v for k, v in want.items()}
    before = [p.detach().clone() for p in state.model.parameters()]
    row = chip_smoke.hold_train_runs("lidar train step", state, g_step, step,
                                     (batch, tokens))
    [(updates, trace)] = row["counts"]
    assert updates == state.step == int(state.optimizer.count)
    assert trace[-1]["count"] == state.step
    assert _max_diff(list(state.model.parameters()), before) > 0
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_parity_modes_launch_the_knn_kernel(cuda):
    from tpu3dssf_torch.voxel import devoxelize_nearest, voxelize

    pts = torch.cat([torch.rand(2, 3000, 3) * 40 - 20,
                     torch.rand(2, 3000, 1)], -1).to(cuda)
    mask = torch.ones(2, 3000, dtype=torch.bool, device=cuda)
    before = knn.LAUNCHES
    vox = voxelize(pts, mask, 0.5, 2048, "knn5")
    vals = torch.randn(2, 2048, 4, device=cuda, requires_grad=True)
    out, _ = devoxelize_nearest(pts[..., :3], mask, vox.voxel_raw[..., :3],
                                vox.voxel_mask, vals)
    out.sum().backward()
    torch.cuda.synchronize()
    assert knn.LAUNCHES == before + 2
    assert torch.isfinite(vox.voxel_raw).all() and vals.grad.abs().sum() > 0


KNN_K = list(range(1, 9))


def _knn_same(got, q, r, m, k):
    from tpu3dssf_torch.voxel.voxelize import topk_neighbors_reference
    want = topk_neighbors_reference(q, r, m, k)
    assert got[0].shape == got[1].shape == (q.shape[0], q.shape[1], k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", KNN_K)
def test_knn_kernel_with_a_mask_per_sample(cuda, k):
    """B = 3: 10% and 60% of the refs masked, and a sample with none."""
    q, r, m = _knn_inputs(cuda, 3, 2100, 3000)
    gen = torch.Generator().manual_seed(1)
    m[0] = (torch.rand(3000, generator=gen) > 0.1).to(cuda)
    m[1] = False
    m[2] = (torch.rand(3000, generator=gen) > 0.6).to(cuda)
    d, i = knn.knn(q, r, m, k)
    _knn_same((d, i), q, r, m, k)
    assert (d[1] == knn.BAD_DIST).all() and (i[1] == 0).all()


@pytest.mark.parametrize("k", KNN_K)
def test_knn_kernel_on_a_lattice_with_repeated_points(cuda, k):
    """Integer points (exact ties everywhere), the first 4000 refs repeated
    at 8000; enough work that units are cut into merged segments."""
    gen = torch.Generator().manual_seed(2)
    q = torch.randint(0, 12, (2, 20000, 3), generator=gen).float()
    r = torch.randint(0, 12, (2, 12000, 3), generator=gen).float()
    r[:, 8000:] = r[:, :4000]
    m = torch.rand(2, 12000, generator=gen) > 0.2
    q, r, m = q.to(cuda), r.to(cuda), m.to(cuda)
    assert knn.plan(2, 20000, 12000, k)[1] > 1
    _knn_same(knn.knn(q, r, m, k), q, r, m, k)


@pytest.mark.parametrize("k", [1, 5, 8])
def test_knn_kernel_at_1e4_metre_coordinates(cuda, k):
    """|q|² near 3e8, where an f32 ulp (32) dwarfs the neighbour gaps, so
    many distances round to the same value."""
    q, r, m = _knn_inputs(cuda, 2, 3000, 6000)
    q, r = q + 1e4, r + 1e4
    _knn_same(knn.knn(q, r, m, k), q, r, m, k)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_knn_kernel_keeps_the_literal_order_where_2qr_overflows(cuda, k):
    """Query 0 and refs 0-2 at about 9e18 m: fl(2 q.r) is inf, so the plain
    version's distances are -inf there, and the kernel must take its
    literal sequence (a multiply-add would give finite ones)."""
    q, r, m = _knn_inputs(cuda, 2, 600, 3000)
    r[:, 0], r[:, 1], r[:, 2] = 9.0e18, 9.1e18, 9.2e18
    q[:, 0] = 9.05e18
    m[:, :3] = True
    d, i = knn.knn(q, r, m, k)
    _knn_same((d, i), q, r, m, k)
    assert (d[:, 0] == float("-inf")).all()


@pytest.mark.parametrize("B,Q,R,k", [
    (4, 34816, 34816, 5), (4, 34816, 34816, 1), (3, 1000, 2501, 8),
    (2, 20000, 12000, 3), (1, 77, 200, 5), (65, 600, 9000, 1)])
def test_knn_plan_is_the_split_of_the_cpu_mirror(cuda, B, Q, R, k):
    """The kernel's plan cuts the work as tests/knn_split.py's `segments`
    does (the CPU tests hold that mirror to the plain version): the same
    most segments a unit, and partial lists of that many segments."""
    from knn_split import segments  # tests/knn_split.py
    blocks, maxseg, part, _ = knn.plan(B, Q, R, k)
    unit = 128 * (8 if k == 1 else 4)
    units, tiles = B * -(-Q // unit), -(-R // 512)
    assert 1 <= blocks <= units * tiles
    assert maxseg == max(len(s) for s in segments(units, tiles, blocks))
    assert part == (units * maxseg * unit * k if maxseg > 1 else 0)


def _graph_kernels(fn, pattern):
    """The kernel nodes of a CUDA graph captured over ``fn()`` whose
    function name matches ``pattern``: {name: count}. A capture records
    every launch of the call as a node, where a profiler may lose the
    records of a window."""
    import re
    import tempfile
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                     # the first call, eager
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    g.enable_debug_mode()
    with torch.cuda.graph(g, stream=stream):
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/graph.dot"
        g.debug_dump(path)
        text = open(path).read()
    found = {}
    # one statement per node, its label over several lines
    for body in re.findall(r'"\w+"\s*\[(.*?)\];', text, re.S):
        m = re.search(pattern, body)
        if m:
            found[m.group(0)] = found.get(m.group(0), 0) + 1
    return found


def test_knn_counts_one_launch_and_its_device_kernels(cuda):
    """One LAUNCHES a call; two device kernels (pack, scan) where each unit
    is one segment (here: one ref tile), three (and the merge) where the
    plan cuts units: the kernel nodes of a CUDA graph captured over the
    call."""
    for B, Q, R, k in ((2, 77, 200, 5), (4, 9000, 20000, 5),
                       (4, 9000, 20000, 1)):
        q, r, m = _knn_inputs(cuda, B, Q, R)
        before = knn.LAUNCHES
        knn.knn(q, r, m, k)
        assert knn.LAUNCHES == before + 1
        merged = knn.plan(B, Q, R, k)[1] > 1
        assert merged == (R > 512)
        nodes = _graph_kernels(lambda: knn.knn(q, r, m, k),
                               r"knn_(pack|kernel|merge)")
        want = {"knn_pack": 1, "knn_kernel": 1}
        if merged:
            want["knn_merge"] = 1
        assert nodes == want, nodes


# The D = 64 kernels (wgmma, TMA, a K/V ring; the backward in one pass with
# dq summed by f32 atomics, so its last bits vary from run to run): ragged
# N around the 64-query and 128-key tiles, packed and (B, N, H, D) views,
# q pre-scaled (1), scaled by 1/8 or by 0.3 (the forward rounds q_s in
# shared memory; the backward folds bf16(q_scale) into its f32 products,
# exact for a power of two and about 2**-9 of a value off for 0.3)
D64_N = [1, 63, 64, 65, 127, 128, 129, 2845]


def _d64_inputs(cuda, N, packed, seed=0):
    """q, k, v views at D = 64 (B = 2, H = 6) of one bf16 (B, N, 3C)
    projection, packed (head h at channel 64 h of each third) or as
    (B, N, 3, H, D); a bias masking the last 5 keys of batch row 0 with
    -1e9 and every key of batch row 1 with -inf, so row 1 is all-masked
    (out 0, LSE +inf); an upstream gradient."""
    B, H, D = 2, 6, 64
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, N, 3 * H * D, generator=gen).to(cuda, torch.bfloat16)
    if packed:
        q, k, v = fa._split_heads(qkv, H)
    else:
        q, k, v = qkv.unflatten(-1, (3, H, D)).unbind(2)
    bias = torch.zeros(B, 1, N)
    if N > 5:
        bias[0, :, -5:] = -1e9
    bias[1] = -float("inf")
    dout = torch.randn(B, N, H, D, generator=gen).to(cuda, torch.bfloat16)
    return q, k, v, bias.to(cuda), dout


def _close(got, want, what):
    """Within 0.05 · max(1, max |plain|) and 2% of max |plain| (one bf16
    ulp is at most 2**-7 of a value)."""
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    assert torch.isfinite(got.float()).all(), what
    assert err < TOL * max(1.0, top) and err <= 0.02 * top + 1e-6, \
        (what, err, top)


@pytest.mark.parametrize("N", D64_N)
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("q_scale", [1.0, 0.125, 0.3])
def test_d64_forward_and_backward_match_their_plain_versions(cuda, N, packed,
                                                             q_scale):
    q, k, v, bias, dout = _d64_inputs(cuda, N, packed)
    out, lse = _flash_lse(q, k, v, bias, q_scale)
    plain = _flash(q, k, v, bias, q_scale)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_lse_reference(q, k, v, bias, q_scale)
    _close(out[0], ref[0], "out")
    assert (lse[0] - ref_lse[0]).abs().max().item() < 1e-3
    assert out[1].abs().max().item() == 0.0
    _close(plain[0], ref[0], "out without LSE")
    assert plain[1].abs().max().item() == 0.0
    assert bool((lse[1] == float("inf")).all())
    delta = fa.row_delta(dout, out)
    got = _flash_bwd(q, k, v, bias, dout, lse, delta, q_scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, bias, dout, lse, delta,
                                            q_scale)
    top = max(w[0].float().abs().max().item() for w in want)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = (a[0].float() - b[0].float()).abs().max().item()
        assert torch.isfinite(a.float()).all(), name
        # dq and dk are 0 up to rounding at N = 1: one scale for the three
        assert err < TOL * max(1.0, top) and err <= 0.02 * top + 1e-6, \
            (name, err, top)
        assert a[1].abs().max().item() == 0.0, name   # the all-masked row


def test_k1_at_the_dinov2_shape(cuda):
    """K1 as the dinov2 ViT-S/14 encoder calls it: 6 cameras of 2 scenes
    (B = 12), 1 + 16 x 16 tokens (N = 257: one valid row in the last
    64-row query tile, one key in the last 128-key tile), H = 6, D = 64,
    no RoPE, q_scale 1/8, every key live; one launch, held against its
    plain version within 0.05 · max(1, max |plain|) and 2% of max |plain|,
    the last query row alone too."""
    gen = torch.Generator().manual_seed(257)
    qkv = torch.randn(12, 257, 3 * 384, generator=gen).to(cuda,
                                                           torch.bfloat16)
    bias = wa.key_bias(torch.ones(12, 257, dtype=torch.bool, device=cuda))
    before = fa.LAUNCHES
    out = fa.flash_attention_packed(qkv, bias, 6, 0.125)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref = fa.flash_attention_packed_reference(qkv, bias, 6, 0.125)
    _close(out, ref, "dinov2 K1")
    _close(out[:, -1], ref[:, -1], "dinov2 K1, the last query row")


def test_d64_launches_count_once_each(cuda):
    """A D = 64 call counts once as K1 (packed), K8 and K9."""
    q, k, v, bias, dout = _d64_inputs(cuda, 300, packed=True)
    qkv = torch.randn(2, 300, 3 * 384, device=cuda).to(torch.bfloat16)
    before = (fa.LAUNCHES, fa.FLASH_LAUNCHES, fa.FLASH_BWD_LAUNCHES)
    fa.flash_attention_packed(qkv, bias, 6)
    after = (fa.LAUNCHES, fa.FLASH_LAUNCHES, fa.FLASH_BWD_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [1, 0, 0]
    fa.flash_attention(q, k, v, bias)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*leaves, bias).backward(dout)
    torch.cuda.synchronize()
    final = (fa.LAUNCHES, fa.FLASH_LAUNCHES, fa.FLASH_BWD_LAUNCHES)
    assert [a - b for a, b in zip(final, after)] == [0, 2, 1]


# K1's RoPE branch (D = 64): q·q_scale (the f32 scale) rotated in the
# kernel's pass over the Q tile, k rotated once by a pre-kernel into a
# scratch; random tables with identity rows for min(5, N) prefix tokens
def _rope_inputs(cuda, N, seed=0):
    """A bf16 (2, N, 3·384) projection (H = 6), a bias masking the last 5
    keys of batch row 0 with -1e9 and every key of row 1 with -inf (row 1
    all-masked: out 0, LSE +inf), the (N, 32) tables and an upstream
    gradient."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(2, N, 3 * 384, generator=gen).to(cuda, torch.bfloat16)
    bias = torch.zeros(2, 1, N)
    if N > 5:
        bias[0, :, -5:] = -1e9
    bias[1] = -float("inf")
    n_pre = min(5, N)
    angles = torch.rand(N - n_pre, 32, generator=gen) * 6 - 3
    cos = torch.cat([torch.ones(n_pre, 32), torch.cos(angles)])
    sin = torch.cat([torch.zeros(n_pre, 32), torch.sin(angles)])
    dout = torch.randn(2, N, 384, generator=gen).to(cuda, torch.bfloat16)
    return qkv, bias.to(cuda), cos.to(cuda), sin.to(cuda), dout


@pytest.mark.parametrize("N", D64_N)
@pytest.mark.parametrize("q_scale", [0.125, 0.3])
def test_rope_forward_matches_its_plain_version(cuda, N, q_scale):
    qkv, bias, cos, sin, _ = _rope_inputs(cuda, N)
    before = fa.LAUNCHES
    out = fa.flash_attention_packed(qkv, bias, 6, q_scale, cos, sin)
    lse_out, lse = _lse(qkv, bias, 6, q_scale, cos, sin)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 2   # the RoPE branch's LSE counts as K1
    ref, ref_lse = fa.flash_attention_packed_lse_reference(
        qkv, bias, 6, q_scale, cos, sin)
    _close(out[0], ref[0], "out")
    _close(lse_out[0], ref[0], "out with LSE")
    assert (lse[0] - ref_lse[0]).abs().max().item() < 1e-3
    assert out[1].abs().max().item() == 0.0 == lse_out[1].abs().max().item()
    assert bool((lse[1] == float("inf")).all())


def test_rope_rule_launches_k1_and_k9(cuda):
    """The training rule with tables: one K1 (its forward with LSE) and one
    K9; the gradient vs autograd of the plain version in f32."""
    qkv, bias, cos, sin, dout = _rope_inputs(cuda, 300)
    bias[1] = 0.0                       # live rows: the plain autograd
    counts = (fa.LAUNCHES, fa.LSE_LAUNCHES, fa.BWD_LAUNCHES,
              fa.FLASH_LAUNCHES, fa.FLASH_BWD_LAUNCHES)
    x = qkv.detach().requires_grad_()
    fa.flash_attention_packed(x, bias, 6, 0.125, cos, sin).backward(dout)
    torch.cuda.synchronize()
    after = (fa.LAUNCHES, fa.LSE_LAUNCHES, fa.BWD_LAUNCHES,
             fa.FLASH_LAUNCHES, fa.FLASH_BWD_LAUNCHES)
    assert [a - b for a, b in zip(after, counts)] == [1, 0, 0, 0, 1]
    f32 = qkv.detach().float().requires_grad_()
    fa.flash_attention_packed_reference(f32, bias, 6, 0.125, cos,
                                        sin).backward(dout.float())
    _grads_close([x.grad], [f32.grad])


@pytest.mark.parametrize("H", [3, 4, 8])
@pytest.mark.parametrize("N", [77, 2845])
def test_rope_forward_at_the_tensor_parallel_head_counts(cuda, H, N):
    """K1's RoPE branch at the head counts of a tensor-parallel shard (ViT-S
    at TP = 2: 3 heads, C = 192; ViT-L at TP = 4: 4 heads, C = 256; ViT-L
    at TP = 2: 8 heads, C = 512) on the contiguous local qkv, against its
    plain version."""
    gen = torch.Generator().manual_seed(H * N)
    qkv = torch.randn(2, N, 3 * 64 * H, generator=gen).to(cuda,
                                                           torch.bfloat16)
    bias = torch.zeros(2, 1, N)
    bias[1, :, -5:] = -1e9
    n_pre = min(5, N)
    angles = torch.rand(N - n_pre, 32, generator=gen) * 6 - 3
    cos = torch.cat([torch.ones(n_pre, 32), torch.cos(angles)]).to(cuda)
    sin = torch.cat([torch.zeros(n_pre, 32), torch.sin(angles)]).to(cuda)
    bias = bias.to(cuda)
    before = fa.LAUNCHES
    out = fa.flash_attention_packed(qkv, bias, H, 0.125, cos, sin)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref = fa.flash_attention_packed_reference(qkv, bias, H, 0.125, cos, sin)
    _close(out, ref, f"H={H} N={N}")


def test_rope_refuses_what_it_does_not_take(cuda):
    qkv, bias, cos, sin, _ = _rope_inputs(cuda, 64)
    before = fa.LAUNCHES
    with pytest.raises(RuntimeError, match="head dim 64 only"):   # D = 16
        fa.flash_attention_packed(qkv, bias, 24, 0.25, cos[:, :8].contiguous(),
                                  sin[:, :8].contiguous())
    with pytest.raises(RuntimeError, match="rope_cos/rope_sin"):
        fa.flash_attention_packed(qkv, bias, 6, 0.125, cos.double(), sin)
    with pytest.raises(RuntimeError, match="rope_cos/rope_sin"):
        fa.flash_attention_packed(qkv, bias, 6, 0.125, cos[:-1], sin[:-1])
    with pytest.raises(RuntimeError, match="both"):
        fa.flash_attention_packed(qkv, bias, 6, 0.125, cos, None)
    assert fa.LAUNCHES == before


# The D = 16 kernels (PTv3): the forward (one warp per (row, head) up to
# N = 64, else 128 query rows a CTA over a cp.async ring of 128-key tiles)
# and the one-pass backward (up to 256 keys a CTA; beyond, per-block dq
# partials summed in block order by a second kernel), at N around each
# of those edges, 1 to 32 heads, the three view layouts the routes hand
# them, q_scale 1 and 0.25
D16_N = [1, 15, 47, 48, 63, 64, 65, 1000, 1024, 1100, 2100]
D16_HEADS = dict(zip(D16_N, (1, 32, 2, 16, 4, 8, 1, 2, 32, 4, 8)))


def _d16_inputs(cuda, N, layout, seed=0):
    """q, k, v at D = 16 (B = 3, H from D16_HEADS) as views of a packed
    (B, N, 3C) projection (head h at channel 16 h of each third), as
    (B, N, 3, H, 16) views of one buffer (the window route's) or as three
    contiguous tensors; a bias masking 30% of batch row 0's keys with -1e9,
    every key of row 1 with -1e9 (a uniform average) and of row 2 with -inf
    (out 0, LSE +inf); the live rows' mask and an upstream gradient that is
    0 on masked query rows, as the callers pass it."""
    B, H, D = 3, D16_HEADS[N], 16
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, N, 3 * H * D, generator=gen).to(cuda, torch.bfloat16)
    if layout == "packed":
        q, k, v = fa._split_heads(qkv, H)
    else:
        q, k, v = qkv.unflatten(-1, (3, H, D)).unbind(2)
        if layout == "tensors":
            q, k, v = (x.contiguous() for x in (q, k, v))
    keep = torch.rand(B, N, generator=gen) > 0.3
    keep[0, 0] = True
    keep[1:] = False
    bias = torch.where(keep, 0.0, -1e9)[:, None, :]
    bias[2] = -float("inf")
    dout = torch.randn(B, N, H, D, generator=gen) * keep[..., None, None]
    return (q, k, v, bias.to(cuda).contiguous(), keep.to(cuda),
            dout.to(cuda, torch.bfloat16))


@pytest.mark.parametrize("N", D16_N)
@pytest.mark.parametrize("layout", ["packed", "windows", "tensors"])
@pytest.mark.parametrize("q_scale", [1.0, 0.25])
def test_d16_forward_matches_its_plain_version(cuda, N, layout, q_scale):
    q, k, v, bias, _, _ = _d16_inputs(cuda, N, layout)
    out = _flash(q, k, v, bias, q_scale)
    lse_out, lse = _flash_lse(q, k, v, bias, q_scale)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_lse_reference(q, k, v, bias, q_scale)
    for got in (out, lse_out):
        _close(got[:2], ref[:2], "out")   # rows 0 and 1 (uniform average)
        assert got[2].abs().max().item() == 0.0   # every key -inf
    assert (lse[:2] - ref_lse[:2]).abs().max().item() < 1e-3
    assert bool((lse[2] == float("inf")).all())


@pytest.mark.parametrize("N", D16_N)
@pytest.mark.parametrize("layout", ["packed", "windows", "tensors"])
@pytest.mark.parametrize("q_scale", [1.0, 0.25])
def test_d16_backward_matches_its_plain_version_bit_for_bit_twice(
        cuda, N, layout, q_scale):
    q, k, v, bias, keep, dout = _d16_inputs(cuda, N, layout)
    out, lse = _flash_lse(q, k, v, bias, q_scale)
    delta = fa.row_delta(dout, out)
    got = _flash_bwd(q, k, v, bias, dout, lse, delta, q_scale)
    again = _flash_bwd(q, k, v, bias, dout, lse, delta, q_scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, bias, dout, lse, delta,
                                            q_scale)
    top = max(w[0].float().abs().max().item() for w in want)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        assert torch.equal(a, c), f"{name} differs between two launches"
        err = (a[0].float() - b[0].float()).abs().max().item()
        assert torch.isfinite(a.float()).all(), name
        assert err < TOL * max(1.0, top) and err <= 0.02 * top + 1e-6, \
            (name, err, top)
        # rows 1 and 2: every key masked, every query's gradient 0
        assert a[1:].abs().max().item() == 0.0, name


def test_d16_launches_count_once_each(cuda):
    """A D = 16 call counts once as K1 (packed), K6 (window route), K2 and
    K3 (packed training rule) and K4 and K5 (window training rule), at
    N = 48 and at N = 1100 (two device kernels for the backward there)."""
    for N in (48, 1100):
        q, k, v, bias, keep, dout = _d16_inputs(cuda, N, "windows")
        qkv = torch.randn(3, N, 96, device=cuda).to(torch.bfloat16)
        before = (fa.LAUNCHES, fa.LSE_LAUNCHES, fa.BWD_LAUNCHES, wa.LAUNCHES,
                  wa.LSE_LAUNCHES, wa.BWD_LAUNCHES)
        fa.flash_attention_packed(qkv, bias, 2, 0.25)
        wa.window_attention(q, k, v, keep)
        x = qkv.detach().requires_grad_()
        fa.flash_attention_packed(x, bias, 2, 0.25)[:2].float().sum().backward()
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        wa.window_attention(*leaves, keep).backward(dout)
        torch.cuda.synchronize()
        after = (fa.LAUNCHES, fa.LSE_LAUNCHES, fa.BWD_LAUNCHES, wa.LAUNCHES,
                 wa.LSE_LAUNCHES, wa.BWD_LAUNCHES)
        assert [a - b for a, b in zip(after, before)] == [1] * 6
        assert torch.isfinite(x.grad.float()).all()
        assert max(t.grad[1:].abs().max().item() for t in leaves) == 0.0


def test_d16_backward_block_size_matches_the_kernel(cuda):
    """The key blocks that the wrappers count by are the built kernel's."""
    assert torch.ops.tpu3dssf_cuda.constant(
        "fa_backward_d16_block_keys") == fa.D16_BWD_KEYS


# the kernels as torch.library ops (tpu3dssf_torch/kernels/ops.py): each op
# on the card against its CPU kernel (the plain version) on the same bf16
# inputs, one count a call for the TPU kernel it names
def _op_cases(cuda, D):
    gen = torch.Generator().manual_seed(7)
    B, N, H = 2, 77, 6 if D == 64 else 3
    C = H * D
    qkv = torch.randn(B, N, 3 * C, generator=gen).to(cuda, torch.bfloat16)
    keep = torch.rand(B, N, generator=gen) > 0.3
    keep[:, 0] = True
    bias = torch.where(keep, 0.0, -1e9)[:, None, :].to(cuda).contiguous()
    keep = keep.to(cuda)
    dout = torch.randn(B, N, C, generator=gen).to(cuda, torch.bfloat16)
    scale = D ** -0.5
    out, lse = fa.flash_attention_packed_lse_reference(qkv, bias, H, scale)
    delta = fa.row_delta(dout, out, H)
    q, k, v = fa._split_heads(qkv, H)
    do4 = dout.unflatten(-1, (H, D))
    cases = [
        ("packed_attention", (qkv, bias, H, scale, None, None), "K1"),
        ("packed_attention_lse", (qkv, bias, H, scale, None, None, "K2"),
         "K2"),
        ("packed_attention_lse", (qkv, bias, H, scale, None, None, "K4"),
         "K4"),
        ("packed_attention_bwd", (qkv, bias, dout, lse, delta, H, scale,
                                  "K3"), "K3"),
        ("packed_attention_bwd", (qkv, bias, dout, lse, delta, H, scale,
                                  "K5"), "K5"),
        ("attention", (q, k, v, bias, None, "K8"), "K8"),
        ("attention", (q, k, v, bias, keep, "K6"), "K6"),
        ("attention_lse", (q, k, v, bias, scale, "K8"), "K8"),
        ("attention_lse", (q, k, v, bias, scale, "K4"), "K4"),
        ("attention_bwd", (q, k, v, bias, do4, lse, delta.contiguous(),
                           scale, "K9"), "K9"),
        ("attention_bwd", (q, k, v, bias, do4, lse, delta.contiguous(),
                           scale, "K5"), "K5"),
    ]
    if D == 64:
        angles = torch.rand(N, 32, generator=gen) * 6 - 3
        cos, sin = torch.cos(angles).to(cuda), torch.sin(angles).to(cuda)
        cases += [
            ("packed_attention", (qkv, bias, H, 0.125, cos, sin), "K1"),
            ("packed_attention_lse", (qkv, bias, H, 0.125, cos, sin, "K1"),
             "K1")]
    else:
        queries, refs, mask = _knn_inputs(cuda, 2, 300, 500)
        cases.append(("knn", (queries, refs, mask, 5), "K7"))
    return cases


@pytest.mark.parametrize("D", [16, 64])
def test_ops_on_the_card_match_their_cpu_kernels(cuda, D):
    for name, args, kernel in _op_cases(cuda, D):
        op = getattr(torch.ops.tpu3dssf, name)
        got = None

        def run():
            nonlocal got
            got = op(*args)
        assert _launches(run) == {kernel: 1}, name
        want = op(*(a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(g.device.type == "cuda" for g in got)
        if name == "knn":
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        elif name.endswith("_bwd"):
            _grads_close([g.cpu() for g in got], want)
        else:
            assert (got[0].cpu().float() - want[0].float()).abs().max() < TOL
            if len(got) == 2:
                assert (got[1].cpu() - want[1]).abs().max().item() < 1e-3


def _tiny_parity_model(cuda):
    """A tiny LiDAR-only model in the parity modes on the card (K1 3 and K7
    2 a call) and its inputs."""
    from tpu3dssf_torch.models import fusion, lidar_only, ptv3
    from tpu3dssf_torch.models.layers import init_weights

    bf16 = torch.bfloat16
    cfg = fusion.PipelineConfig(
        fusion=fusion.FusionConfig(output_dim=16, dtype=bf16),
        ptv3=ptv3.PTv3Config(
            enc_depths=(1, 1), enc_channels=(32, 128), enc_heads=(2, 8),
            enc_window=(128, 128), dec_depths=(1,), dec_channels=(32,),
            dec_heads=(2,), dec_window=(128,), dtype=bf16),
        voxel_size=0.4, voxel_capacity=1024, intensity_mode="knn5",
        devoxelize_mode="nearest")
    model = init_weights(lidar_only.LidarSegmentationModel(cfg), 2)
    model = model.to(cuda).eval()
    gen = torch.Generator().manual_seed(4)
    pts = torch.cat([torch.rand(2, 3000, 3, generator=gen) * 40 - 20,
                     torch.rand(2, 3000, 1, generator=gen)], -1).to(cuda)
    mask = (torch.rand(2, 3000, generator=gen) > 0.1).to(cuda)
    return model, pts, mask


def test_export_round_trip_on_the_card_counts_its_launches(cuda, tmp_path):
    """A tiny LiDAR-only model in the parity modes, exported on the card:
    the loaded program's first call (eager) and its replay each launch
    K1 3 and K7 2, as the eager model does, and give its output."""
    from tpu3dssf_torch.export import export_infer_bytes, load_exported

    model, pts, mask = _tiny_parity_model(cuda)
    path = tmp_path / "model.pt2"
    path.write_bytes(export_infer_bytes(model, (pts, mask)))
    with torch.no_grad():
        eager = [model(pts, mask) for _ in range(2)]
        counts = _launches(lambda: model(pts, mask))
    assert counts == {"K1": 3, "K7": 2}
    f = load_exported(path.read_bytes())
    outs = []
    for _ in range(2):
        assert _launches(lambda: outs.append(f(pts, mask))) == counts
    assert len(f.graphs) == 1
    spread = _max_diff([eager[0]], [eager[1]])
    assert all(_within_eager(_max_diff([o], [eager[0]]), spread)
               for o in outs)


def test_aoti_package_on_the_card_counts_its_launches(cuda, tmp_path):
    """The same model as an AOTInductor package: loaded in Python, each
    call launches K1 3 and K7 2 through the C++ ops and gives the eager
    output within 2% of its largest value; ``aoti_runner``, a process
    without Python, launches the same and writes the same bits."""
    import json
    import subprocess
    from tpu3dssf_torch.export import (compile_infer_package, load_package,
                                       read_outputs, write_inputs)
    from tpu3dssf_torch.kernels import _build

    model, pts, mask = _tiny_parity_model(cuda)
    with torch.no_grad():
        eager = model(pts, mask)
    path = compile_infer_package(model, (pts, mask), tmp_path / "m.pt2")
    f = load_package(path)
    outs = []
    for _ in range(2):
        assert _launches(lambda: outs.append(f(pts, mask))) == {"K1": 3,
                                                               "K7": 2}
    got = outs[0][0] if isinstance(outs[0], (list, tuple)) else outs[0]
    top = eager.float().abs().max().item()
    assert (got.float() - eager.float()).abs().max().item() <= 0.02 * top
    write_inputs(tmp_path / "in", (pts, mask))
    (tmp_path / "out").mkdir()
    res = subprocess.run(
        [str(_build.build_runner()), str(path), "cuda", str(tmp_path / "in"),
         str(tmp_path / "out"), "3",
         *map(str, _build.loaded_libraries())],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["launches_per_call"] == {"K1": 3, "K7": 2}
    assert torch.equal(read_outputs(tmp_path / "out")[0], got.cpu())
