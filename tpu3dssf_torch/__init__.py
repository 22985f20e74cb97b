"""tpu3dssf_torch — the PyTorch + CUDA port of tpu3dssf for NVIDIA Hopper.

Mirrors the JAX package's module paths (``tpu3dssf_torch.models.ptv3`` ↔
``tpu3dssf.models.ptv3``) and keeps its own copies of the JAX package's
host code (``tpu3dssf_torch.config``, ``tpu3dssf_torch.data``,
``tpu3dssf_torch.utils.logging``, ``tpu3dssf_torch.utils.viz``). Plain
tensor code is PyTorch; the kernels that the JAX package wrote in Pallas
for the TPU are CUDA kernels written for Hopper (``csrc/``), built with
nvcc at first use. This package imports neither JAX nor ``tpu3dssf``.
"""

__version__ = "0.1.0"
