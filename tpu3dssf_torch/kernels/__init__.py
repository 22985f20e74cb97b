"""The port's kernels: the wrappers, their plain versions, and the
``torch.library`` ops ``tpu3dssf::*`` (:mod:`tpu3dssf_torch.kernels.ops`),
which importing this package registers."""

from tpu3dssf_torch.kernels.flash_attention import (
    FlashAttention,
    FlashAttentionPacked,
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_lse_reference,
    flash_attention_packed,
    flash_attention_packed_bwd_reference,
    flash_attention_packed_lse_reference,
    flash_attention_packed_reference,
    mha_reference,
    pick_head_group,
)
from tpu3dssf_torch.kernels.layer_norm import (
    LayerNormFunction,
    layer_norm,
    layer_norm_bwd_reference,
    layer_norm_reference,
)
from tpu3dssf_torch.kernels.window_attention import (
    WindowAttentionPacked,
    window_attention,
    window_attention_packed,
    window_attention_reference,
)
from tpu3dssf_torch.kernels import knn, ops  # noqa: F401  (registers the ops)

__all__ = [
    "FlashAttention",
    "FlashAttentionPacked",
    "LayerNormFunction",
    "WindowAttentionPacked",
    "flash_attention",
    "flash_attention_bwd_reference",
    "flash_attention_lse_reference",
    "flash_attention_packed",
    "flash_attention_packed_bwd_reference",
    "flash_attention_packed_lse_reference",
    "flash_attention_packed_reference",
    "layer_norm",
    "layer_norm_bwd_reference",
    "layer_norm_reference",
    "mha_reference",
    "pick_head_group",
    "window_attention",
    "window_attention_packed",
    "window_attention_reference",
]
