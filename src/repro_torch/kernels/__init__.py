"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Every kernel ships as
  csrc/<name>.cu   — the CUDA C++ body for sm_90a (plain C interface),
  <name>.py        — the plain PyTorch version of the same function, and
                     the ctypes launch of the kernel,
  ops.py           — the one public wrapper: a CPU tensor goes to the plain
                     version, a CUDA tensor launches the kernel (or raises);
                     each wrapper counts its launches in `ops.LAUNCHES`.
`build.py` compiles the sources at first use. Nothing here builds or imports
a compiler when the package is imported.
"""
