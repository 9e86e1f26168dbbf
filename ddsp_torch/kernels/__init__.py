"""Hand-written CUDA kernels (sources in ddsp_torch/csrc/) and their wrappers.

Each wrapper is a torch.autograd.Function that launches its kernels for a
CUDA tensor, forward and backward, or raises; it takes the plain PyTorch
versions beside them only for a tensor on the CPU. Nothing is built or
loaded at import: the first launch builds the library with nvcc.

  K1f harmonic.fused_harmonic_synthesis  <- ddsp_tpu harmonic.py:_fwd_kernel
  K1t   its backward, amplitude taps     <- harmonic.py:_bwd_taps_kernel
  K1p   its backward, phase              <- harmonic.py:_bwd_phase_kernel
  K2f gru.gru_sequence                   <- ddsp_tpu gru.py:_fwd_kernel
  K2b   its backward                     <- gru.py:_bwd_kernel
"""

from ddsp_torch.kernels import gru, harmonic

__all__ = ['gru', 'harmonic']
