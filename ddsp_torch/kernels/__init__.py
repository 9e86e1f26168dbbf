"""Hand-written CUDA kernels (sources in ddsp_torch/csrc/) and their wrappers.

Each wrapper launches its kernel for a CUDA tensor, or raises; it takes the
plain PyTorch version beside it only for a tensor on the CPU. Nothing is
built or loaded at import: the first launch builds the library with nvcc.

  K1  harmonic.fused_harmonic_synthesis  <- ddsp_tpu harmonic.py:_fwd_kernel
  K2  gru.gru_sequence                   <- ddsp_tpu gru.py:_fwd_kernel
"""

from ddsp_torch.kernels import gru, harmonic

__all__ = ['gru', 'harmonic']
