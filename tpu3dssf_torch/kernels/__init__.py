from tpu3dssf_torch.kernels.flash_attention import (
    FlashAttentionPacked,
    flash_attention_packed,
    flash_attention_packed_bwd_reference,
    flash_attention_packed_lse_reference,
    flash_attention_packed_reference,
)
from tpu3dssf_torch.kernels.window_attention import (
    WindowAttentionPacked,
    window_attention_packed,
    window_attention_reference,
)

__all__ = [
    "FlashAttentionPacked",
    "WindowAttentionPacked",
    "flash_attention_packed",
    "flash_attention_packed_bwd_reference",
    "flash_attention_packed_lse_reference",
    "flash_attention_packed_reference",
    "window_attention_packed",
    "window_attention_reference",
]
