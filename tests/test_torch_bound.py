"""The attention bound of chip_smoke.py and its exp term, on the CPU.

``chip_smoke.attention_bound`` is the least time an H100 could take for
one attention call: the longest of the bf16 products at 989 TFLOP/s, the
f32 operations at 67 TFLOP/s, the exps on the special-function units (16
``ex2`` per clock per SM, 132 SMs, at the SM clock; 1980 MHz here, the
H100 SXM's maximum) and the bytes at 3.35 TB/s. These tests redo that
arithmetic by hand at the ViT-S, ViT-L and PTv3 shapes; chip_smoke's
module level imports only the standard library, so no card is needed.
"""

import pytest

import chip_smoke as cs

EXP_RATE = 16 * 132 * 1980e6


def by_hand(B, N, C, H, kind, exp=True, rope=False):
    """(ms, term) of one call, the arithmetic of the bound written out;
    without the exp term where ``exp`` is False (the bound before it); with
    ``rope`` the rotation of q (with its scale: 8 f32 operations per channel
    pair) and of k (6) once per token, and the two f32 tables read once."""
    scores = B * H * N * N
    products = (10 if kind == "bwd" else 4) * B * N * N * C
    if kind == "bwd":
        nbytes = B * N * (6 * C + 4 + 2 * C + 8 * H + 6 * C)
    else:
        nbytes = B * N * (8 * C + 4 + (4 * H if kind == "lse" else 0))
    f32_ops = 4 * scores
    if rope:
        D = C // H
        f32_ops += B * N * H * (8 + 6) * D // 2
        nbytes += 2 * N * (D // 2) * 4
    times = {"operations": max(products / 989e12, f32_ops / 67e12),
             "exp": scores / EXP_RATE if exp else 0.0,
             "bytes": nbytes / 3.35e12}
    term = max(times, key=times.get)
    return times[term] * 1e3, term


# (B, N, C, H): the ViT-S/16 and ViT-L/16 encoders at 12 images of
# 640 x 1138 (2845 tokens), a PTv3 stage at window 48 and at window 1024
VIT_S = (12, 2845, 384, 6)
VIT_L = (12, 2845, 1024, 16)
WINDOW_48 = (2904, 48, 32, 2)
WINDOW_1024 = (68, 1024, 32, 2)
SHAPES = [VIT_S, VIT_L, WINDOW_48, WINDOW_1024]
KINDS = ["fwd", "lse", "bwd"]


def test_exp_rate_is_16_per_clock_per_sm():
    assert cs.exp_rate(1980.0) == pytest.approx(EXP_RATE, rel=1e-12)
    assert cs.EXP_RATE == pytest.approx(EXP_RATE, rel=1e-12)


@pytest.mark.parametrize("shape,kind,want_ms,want_term", [
    # ViT-S forward: products 1.4918e11 / 989e12 = 0.1508 ms beat the
    # 5.8277e8 exps at 4.1818e12/s = 0.1394 ms
    (VIT_S, "fwd", 0.150848, "operations"),
    # ViT-L: exps 0.3716 ms, products 0.4022 ms
    (VIT_L, "fwd", 0.402262, "operations"),
    # its one-pass backward: products 1.0057 ms, one exp a score 0.3716 ms
    (VIT_L, "bwd", 1.005656, "operations"),
    # window 48 at D = 16: 36.2 MB of bytes take longer than 13.4 M exps
    (WINDOW_48, "fwd", 0.010818, "bytes"),
])
def test_bound_by_hand(shape, kind, want_ms, want_term):
    ms, term = cs.attention_bound(*shape, kind)
    hand_ms, hand_term = by_hand(*shape, kind)
    assert ms == pytest.approx(hand_ms, rel=1e-12) and term == hand_term
    assert ms == pytest.approx(want_ms, rel=1e-4)
    assert term == want_term


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_exp_term_never_lowers_the_bound(shape, kind):
    """The bound with the exp term is at least the bound without it (the
    products, f32 operations and bytes alone), and at least the exps'
    own time."""
    B, N, C, H = shape
    ms, _ = cs.attention_bound(*shape, kind)
    assert ms == pytest.approx(by_hand(*shape, kind)[0], rel=1e-12)
    assert ms >= by_hand(*shape, kind, exp=False)[0]
    assert ms >= B * H * N * N / EXP_RATE * 1e3


@pytest.mark.parametrize("kind,over_products", [("fwd", 3.7), ("lse", 3.7),
                                                ("bwd", 1.48)])
def test_d16_window_1024_is_bound_by_the_exp(kind, over_products):
    """At D = 16 and window 1024 the exp is the tightest limit: about 3.7
    times the products in the forward, 1.5 times in the backward. The
    backward counts one exp a score, p = exp(s - lse), however many passes
    a kernel takes (the two-pass D = 16 kernel spends two)."""
    ms, term = cs.attention_bound(*WINDOW_1024, kind)
    assert term == "exp"
    B, N, C, H = WINDOW_1024
    assert ms == pytest.approx(B * H * N * N / EXP_RATE * 1e3, rel=1e-12)
    products = (10 if kind == "bwd" else 4) * B * N * N * C / 989e12 * 1e3
    assert ms / products == pytest.approx(over_products, rel=0.02)


def test_bound_term_and_record():
    rows = [dict(bound_ms=1.0, bound_by="exp"),
            dict(bound_ms=0.4, bound_by="operations"),
            dict(bound_ms=0.7, bound_by="operations")]
    assert cs.bound_term(rows) == "operations"
    assert cs.record_bound_by("exp") == "operations"
    assert cs.record_bound_by("bytes") == "bytes"


@pytest.mark.parametrize("shape", [VIT_S, VIT_L, (2, 77, 384, 6),
                                   (2, 1, 384, 6)])
def test_rope_term_by_hand(shape):
    """K1's RoPE branch: the rotation's f32 operations and the tables'
    bytes join the forward's; at the ViTs' shapes the products still bound
    it (ViT-S: 9.2e7 rotation operations beside 2.3e9 for the scores)."""
    ms, term = cs.attention_bound(*shape, "fwd", rope=True)
    hand_ms, hand_term = by_hand(*shape, "fwd", rope=True)
    assert ms == pytest.approx(hand_ms, rel=1e-12) and term == hand_term
    assert ms >= cs.attention_bound(*shape, "fwd")[0]
    if shape in (VIT_S, VIT_L):
        assert term == "operations"
        assert ms == pytest.approx(by_hand(*shape, "fwd")[0], rel=1e-12)
