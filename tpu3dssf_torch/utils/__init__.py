from tpu3dssf_torch.utils.timing import (StepTimer, cuda_ms, cuda_times,
                                         measure_efficiency, peak_hbm_mb,
                                         profile_kernels)

__all__ = ["StepTimer", "cuda_ms", "cuda_times", "measure_efficiency",
           "peak_hbm_mb", "profile_kernels"]
