"""lbm_tpu_torch — the D2Q9-BGK lattice-Boltzmann solver on PyTorch and CUDA.

A port of ``lbm_tpu`` (JAX/XLA/Pallas on a TPU) to PyTorch with hand-written
CUDA C++ kernels for NVIDIA Hopper (``sm_90a``).  It reads the same
``input_*.params`` / ``obstacles_*.dat`` scenes and writes the same
``av_vels.dat`` / ``final_state.dat`` files, byte for byte in format.  It
imports neither ``jax`` nor ``lbm_tpu``: the numpy-only modules are copies.

Layout, mirroring ``lbm_tpu`` where that helps find the counterpart:

- ``core``    lattice constants, rest equilibrium, the numpy serial oracle.
- ``io``      scene parsing, output writers, reference state hand-over.
- ``ops``     the cell math on tensors (``stencil_math``), the plain torch
              step and sweeps (``fused_torch``), the int16 codec
              (``quant``), and one wrapper module per CUDA kernel family
              (``*_cuda``: K1-K9), each beside its kernel's plain version.
- ``csrc``    the CUDA C++ sources, built with nvcc at first use.
- ``models``  variants, the single-device program and its policy, the run
              driver.
- ``parallel`` the row mesh and the sharded disciplines (sync, overlap,
              async, chunked, ca).
- ``tools``   checker, bench, scene generator, dry run, kernel timing.
- ``utils``   phase timer and invariants.
"""

from lbm_tpu_torch.params import LBMParams

__version__ = "0.1.0"

__all__ = ["LBMParams", "__version__"]
