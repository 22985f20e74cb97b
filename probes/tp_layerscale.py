"""How far ViT-L/16 at tensor parallelism reads from the unsharded encode,
by LayerScale, with K1 sound and with K1's softmax scale planted off: the
readings behind ``tpu3dssf_torch/cli/multichip.py``'s ``TP_LAYERSCALE``.

    torchrun --nproc_per_node 4 probes/tp_layerscale.py
    torchrun --nproc_per_node 2 probes/tp_layerscale.py --backend gloo \\
        --layerscales 1e-5,0.1,0.3,1.0

A (1, ranks) data × model mesh, TP = ranks, over the layout's backend
(NCCL, a card a rank) or gloo (ranks sharing one card). For each
LayerScale it builds the seeded ViT-L (bf16, LayerScale folded), encodes 6
random images at 640 × 1138 unsharded, then at TP with K1 sound and with
K1 served by its plain version at scale × 1.0, 1.1 and 1.25
(``chip_smoke.planted_k1``), and rank 0 prints the card line and one line,
``TPLS {"<layerscale>/<factor>": {max_abs_err, peak, rel}}``, the largest
|TP − unsharded| and its share of the largest |unsharded|.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--layerscales", default="0.1")
    parser.add_argument("--backend", default=None)
    args = parser.parse_args()

    import torch
    import chip_smoke
    import torch.distributed as dist
    from tpu3dssf_torch.cli.common import card_line
    from tpu3dssf_torch.models.layers import init_weights
    from tpu3dssf_torch.models.vit import (ViTConfig, VisionTransformer,
                                           dinov3_large, fold_layerscale,
                                           prepare_tp_params)
    from tpu3dssf_torch.parallel import create_mesh, vit_tp_shardings

    torch.backends.cuda.matmul.allow_tf32 = False
    world = int(os.environ["WORLD_SIZE"])
    mesh = create_mesh((1, world), ("data", "model"), backend=args.backend)
    dev = mesh.device
    gen = torch.Generator().manual_seed(2)
    images = torch.randn((6, 640, 1138, 3), generator=gen).to(
        dev, torch.bfloat16)
    out = {}
    for ls in (float(x) for x in args.layerscales.split(",")):
        cfg = ViTConfig(**{**dinov3_large().__dict__,
                           "dtype": torch.bfloat16, "layerscale_init": ls})
        base = fold_layerscale(init_weights(VisionTransformer(cfg), 1))
        base = base.to(dev).eval()
        with torch.inference_mode():
            want = base(images)["patch_features"].float()
        peak = want.abs().max().item()
        for fault in (None, 1.0, 1.1, 1.25):
            vit = copy.deepcopy(base)
            with torch.inference_mode():
                prepare_tp_params(vit, vit.config, mesh)
                vit_tp_shardings(vit, mesh)
                lib = chip_smoke.planted_k1(fault) if fault else None
                got = vit(images)["patch_features"].float()
                if lib is not None:
                    lib._destroy()
            err = (got - want).abs().max().item()
            out[f"{ls}/{fault}"] = dict(max_abs_err=err, peak=peak,
                                        rel=err / peak)
            del vit
            torch.cuda.empty_cache()
        del base
    if mesh.rank == 0:
        print(card_line())
        print(f"TP = {world} over {mesh.backend}")
        print("TPLS " + json.dumps(out), flush=True)
    dist.barrier()
    mesh.close()


if __name__ == "__main__":
    main()
