"""The port's CUDA kernels (attention K1–K6, K8, K9, k-NN K7), a train step
and the timers on the card (marked ``cuda``).

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
    qkv, bias = _inputs(cuda, 1, 64, 96, False)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_packed(qkv, bias, 3)            # D = 32
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_packed(qkv.float(), bias, 6)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_packed(qkv[:, ::2], bias, 6)
    with pytest.raises(ValueError, match="key_bias"):
        fa.flash_attention_packed(qkv, bias.double(), 6)


def test_profile_kernels_counts_the_kernel_launches(cuda):
    from tpu3dssf_torch.utils import cuda_ms, profile_kernels

    qkv, bias = _inputs(cuda, 4, 1024, 32, True)

    def two_calls():
        fa.flash_attention_packed(qkv, bias, 2, 0.25)
        fa.flash_attention_packed(qkv, bias, 2, 0.25)

    _, kernels, _ = profile_kernels(two_calls, reps=3)
    k1 = [v for k, v in kernels.items() if "fap_fwd_kernel" in k]
    assert sum(n for _, n in k1) == 2
    assert sum(us for us, _ in k1) > 0
    assert cuda_ms(two_calls, reps=3, warmup=1) > 0


# ragged N and up to 32 heads, all at the PTv3 head dim D = 16
GRAD_SHAPES = [(3, 1, 32, 2), (2, 77, 64, 4), (3, 130, 128, 8),
               (4, 1024, 32, 2), (2, 1024, 512, 32)]


@pytest.mark.parametrize("B,N,C,H", GRAD_SHAPES)
def test_lse_kernel_matches_plain_version(cuda, B, N, C, H):
    qkv, bias = _inputs(cuda, B, N, C, masked=N > 1)
    out, lse = fa._launch_lse(qkv, bias, H, (C // H) ** -0.5)
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
    got = fa._launch_bwd(qkv, bias, dout, lse, delta, H, q_scale)
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
    with pytest.raises(ValueError, match="head dim"):   # D = 32: none
        z = qkv[..., :192].contiguous().requires_grad_()
        fa.flash_attention_packed(z, bias, 2, 0.125).sum().backward()


def test_small_model_train_step_on_the_card(cuda):
    from tpu3dssf_torch.cli.common import (HostDataPipeline,
                                           SyntheticNuScenes, batch_to_device)
    from tpu3dssf_torch.losses import CELSLoss
    from tpu3dssf_torch.models import fusion, ptv3
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.train import (TrainState, create_optimizer,
                                      make_train_step)

    bf16 = torch.bfloat16
    cfg = fusion.PipelineConfig(
        fusion=fusion.FusionConfig(point_feat_dim=32, patch_tok_dim=16,
                                   patch_size=8, encoder_size=(48, 80),
                                   dtype=bf16),
        ptv3=ptv3.PTv3Config(
            enc_depths=(1, 1), enc_channels=(32, 128), enc_heads=(2, 8),
            enc_window=(128, 128), dec_depths=(1,), dec_channels=(32,),
            dec_heads=(2,), dec_window=(128,), dtype=bf16),
        voxel_size=0.4, voxel_capacity=1024)
    data = SyntheticNuScenes(num_samples=2, num_points=3000,
                             image_hw=(90, 160), seed=3)
    host = next(iter(HostDataPipeline(data, batch_size=2,
                                      point_capacity=3072)))
    host.pop("images")
    batch = batch_to_device(host, cuda)
    tokens = torch.randn(2, 6, 60, 16, device=cuda).to(bf16)
    model = init_weights(fusion.SegmentationPipeline(cfg), 6).to(cuda)
    state = TrainState(model, create_optimizer(
        model.parameters(), "AdamW", 1e-3, grad_clip=1.0))
    step = make_train_step(CELSLoss(weight=[1.0] * 16))
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
    out, lse = fa._launch_flash(q, k, v, bias, scale, with_lse=True)
    ref, ref_lse = fa.flash_attention_lse_reference(q, k, v, bias, scale)
    assert (out.float() - ref.float()).abs().max().item() < TOL
    assert (lse - ref_lse).abs().max().item() < 1e-3
    delta = fa.row_delta(dout, out)
    got = fa._launch_flash_bwd(q, k, v, bias, dout, lse, delta, scale)
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
    q, k, v, bias, dout = _bhnd_inputs(cuda, 1, 64, 2, 32)     # D = 32
    with pytest.raises(ValueError, match="head dim"):
        fa._launch_flash(q, k, v, bias, 0.2)
    q, k, v, bias, dout = _bhnd_inputs(cuda, 1, 64, 2, 16)
    with pytest.raises(ValueError, match="no kernel"):
        fa._launch_flash(q.cpu(), k.cpu(), v.cpu(), bias.cpu(), 0.25)
    with pytest.raises(TypeError, match="bfloat16"):
        fa._launch_flash(q.float(), k.float(), v.float(), bias, 0.25)
    strided = torch.zeros(1, 64, 2, 32, device=cuda,
                          dtype=torch.bfloat16)[..., ::2]   # D stride 2
    with pytest.raises(ValueError, match="contiguous"):
        fa._launch_flash(strided, k, v, bias, 0.25)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fa._launch_flash_bwd(q, k, v, bias, dout.float(), lse, lse, 0.25)
    with pytest.raises(ValueError, match="lse"):
        fa._launch_flash_bwd(q, k, v, bias, dout, lse[:, :1], lse, 0.25)


def _knn_inputs(cuda, B, Q, R, masked=0.2, seed=0):
    """Points over a 120 m square, as the synthetic scenes span: |q|² up to
    7200, where one f32 ulp is as large as a neighbour gap at 0.1 m."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.rand(B, Q, 3, generator=gen) * 120 - 60
    r = torch.rand(B, R, 3, generator=gen) * 120 - 60
    r[:, 10:20] = r[:, :10]                  # exact ties
    m = torch.rand(B, R, generator=gen) > masked
    return q.to(cuda), r.to(cuda), m.to(cuda)


@pytest.mark.parametrize("B,Q,R,k", [(2, 77, 200, 1), (3, 1000, 2501, 5),
                                     (1, 4097, 1031, 8), (2, 257, 64, 5)])
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
    out, lse = fa._launch_flash(q, k, v, bias, q_scale, with_lse=True)
    plain = fa._launch_flash(q, k, v, bias, q_scale)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_lse_reference(q, k, v, bias, q_scale)
    _close(out[0], ref[0], "out")
    _close(plain[0], ref[0], "out without LSE")
    assert (lse[0] - ref_lse[0]).abs().max().item() < 1e-3
    assert out[1].abs().max().item() == 0.0 == plain[1].abs().max().item()
    assert bool((lse[1] == float("inf")).all())
    delta = fa.row_delta(dout, out)
    got = fa._launch_flash_bwd(q, k, v, bias, dout, lse, delta, q_scale)
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
    lse_out, lse = fa._launch_lse(qkv, bias, 6, q_scale, cos, sin)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
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


def test_rope_refuses_what_it_does_not_take(cuda):
    qkv, bias, cos, sin, _ = _rope_inputs(cuda, 64)
    with pytest.raises(ValueError, match="head dim 64 only"):   # D = 16
        fa.flash_attention_packed(qkv, bias, 24, 0.25, cos[:, :8].contiguous(),
                                  sin[:, :8].contiguous())
    with pytest.raises(ValueError, match="rope_cos/rope_sin"):
        fa.flash_attention_packed(qkv, bias, 6, 0.125, cos.double(), sin)
    with pytest.raises(ValueError, match="rope_cos/rope_sin"):
        fa.flash_attention_packed(qkv, bias, 6, 0.125, cos[:-1], sin[:-1])
    with pytest.raises(ValueError, match="both"):
        fa.flash_attention_packed(qkv, bias, 6, 0.125, cos, None)
