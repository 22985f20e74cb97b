"""The traced window's reduction and the per-layer readers on a hand-made
profiler record."""

from types import SimpleNamespace as NS

import pytest

from benchmark.harness import counts, spec, trace
from benchmark.harness.cells import Record


def ev(name, kind, start, end):
    return NS(name=name, device_type=NS(name=kind),
              time_range=NS(start=start, end=end), is_user_annotation=False)


EVENTS = [ev("bench::h2d", "CPU", 0, 100),
          ev("Memcpy HtoD (Pinned -> Device)", "CUDA", 10, 30),
          ev("void fap_fwd_d16_kernel<false>(FwdArgs)", "CUDA", 50, 80),
          ev("void fap_fwd_d16_kernel<false>(FwdArgs)", "CUDA", 70, 90),
          ev("bench::forward", "CPU", 100, 200),
          ev("void knn_kernel<5, 4>(float4 const*)", "CUDA", 150, 160)]


def test_reduce_merges_busy_time_and_names_the_gaps():
    t = trace.reduce(EVENTS, 2, 200e-6)
    assert t.busy_s == pytest.approx(70e-6)        # 10-30, 50-90, 150-160
    assert t.launches() == 3                       # the copy is no kernel
    assert t.gaps == pytest.approx({"h2d": 20e-6, "forward": 60e-6})
    assert t.breakdown()["device_ops"][0] == [
        "void fap_fwd_d16_kernel<false>(FwdArgs)", pytest.approx(50e-6)]


def test_readers_on_a_hand_made_record():
    t = trace.reduce(EVENTS, 2, 200e-6)
    work = counts.Work(flops=989e12 * 20e-6, attn_s=25e-6, knn_s=5e-6)
    run = Record("eval", {"h2d": [1.0, 3.0]}, t, work)
    read = {m: spec.reader(m)(run) for m in (
        "h2d_ms.eval", "h2d_ms.train", "kernels_per_frame.eval",
        "attn_roofline.eval", "knn_roofline.eval", "device_idle_pct.eval",
        "mfu.eval", "vit_encode_ms.stream", "pipeline_fwd_ms.eval")}
    assert read["h2d_ms.eval"] == 2.0
    assert read["h2d_ms.train"] is None            # another kind of loop
    assert read["vit_encode_ms.stream"] is None   # another kind of loop
    assert read["pipeline_fwd_ms.eval"] is None   # no such span
    assert read["kernels_per_frame.eval"] == 1.5
    assert read["attn_roofline.eval"] == pytest.approx(50.0)
    assert read["knn_roofline.eval"] == pytest.approx(50.0)
    assert read["device_idle_pct.eval"] == pytest.approx(65.0)
    assert read["mfu.eval"] == pytest.approx(10.0)
    nothing = Record("eval", {}, t, counts.Work())
    assert spec.reader("knn_roofline.eval")(nothing) is None
    assert spec.reader("mfu.eval")(nothing) is None
