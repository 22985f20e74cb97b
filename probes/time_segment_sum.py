"""``serialization.segment_sum`` against ``index_add_`` at ``voxelize``'s
shape on the card: the cost of the centroid sums' fixed order.

    python3 probes/time_segment_sum.py

Sums (2, 34,816, 5) f32 rows (xyz, intensity and a count) into 25,600
voxels a batch row, the rows sorted by voxel as ``voxelize`` sorts them:
``index_add_`` (atomics) and ``segment_sum`` (one fixed order), old, new,
old, new, each the CUDA-event mean of 20 calls after 3; then 10
``segment_sum`` calls on random data against each other (bit for bit) and
10 ``scatter_add_`` calls likewise. Prints the card line and one line per
reading.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch
    from tpu3dssf_torch.cli.common import card_line
    from tpu3dssf_torch.serialization import segment_sum

    if not torch.cuda.is_available():
        sys.exit("time_segment_sum.py: no CUDA device is available")
    print(card_line())
    dev = torch.device("cuda")
    B, N, V = 2, 34816, 25600
    pts = torch.randn(B, N, 5, device=dev)
    vs = torch.sort(torch.randint(0, V, (B, N), device=dev), dim=1).values
    flat = (vs + torch.arange(B, device=dev)[:, None] * (V + 1)).reshape(-1)

    def old():
        torch.zeros(B * (V + 1), 5, device=dev).index_add_(
            0, flat, pts.reshape(-1, 5))

    def new():
        segment_sum(pts, vs, V)

    for f in (old, new, old, new):
        for _ in range(3):
            f()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            f()
        b.record()
        torch.cuda.synchronize()
        print(f.__name__, "ms per call", a.elapsed_time(b) / 20)

    g = torch.Generator().manual_seed(0)
    C, S = 64, 4000
    sg = torch.sort(torch.randint(0, S, (B, N), generator=g),
                    dim=1).values.to(dev)
    vals = torch.randn(B, N, C, generator=g).to(dev)
    outs = [segment_sum(vals, sg, S) for _ in range(10)]
    print("segment_sum identical", all(torch.equal(o, outs[0]) for o in outs))
    refs = [torch.zeros(B, S, C, device=dev).scatter_add_(
        1, sg[..., None].expand(-1, -1, C), vals) for _ in range(10)]
    print("scatter_add identical", all(torch.equal(o, refs[0]) for o in refs))


if __name__ == "__main__":
    main()
