"""PyTorch + CUDA port of the Quartet II NVFP4 system (serving slice).

A second package beside the JAX reference in `src/repro/`, mirroring its
layout module for module. It imports `torch` and `numpy` only — never
`jax`, and nothing from `repro`. Its hot kernels (NVFP4 4/6 quantization,
the NVFP4 GEMM, paged GQA decode) are hand-written CUDA C++ for Hopper
(`kernels/csrc/`), built at first use; every kernel has a plain PyTorch
version beside it, which the wrappers in `kernels/ops.py` run for tensors
that lie on the CPU.

Entry point: `python -m repro_torch.launch.serve --arch llama_200m`.
"""

import torch

# Every fp32 matmul of the port (bf16-exact operands, fp32 accumulation) is
# IEEE fp32, as XLA's is on the CPU: TF32 stays off for matmuls and cuDNN.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
