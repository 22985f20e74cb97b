from tpu3dssf_torch.utils.timing import (cuda_ms, cuda_times, enable_spans,
                                         peak_hbm_mb, profile_kernels,
                                         reset_spans, span, span_counters,
                                         span_summary)

__all__ = ["cuda_ms", "cuda_times", "enable_spans", "peak_hbm_mb",
           "profile_kernels", "reset_spans", "span", "span_counters",
           "span_summary"]
