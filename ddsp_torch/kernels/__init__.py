"""Hand-written CUDA kernels (sources in ddsp_torch/csrc/) and their wrappers.

Each wrapper is a torch.autograd.Function that launches its kernels for a
CUDA tensor, forward and backward, or raises; it takes the plain PyTorch
versions beside them only for a tensor on the CPU. K1's and K2's kernels
are torch.library ops (ddsp_torch::harmonic_fwd, ::harmonic_bwd_taps,
::harmonic_bwd_phase, ::gru_fwd, ::gru_bwd; registered when this package
is imported) with CUDA, CPU and fake implementations, so an exported
program (infer/export.py) calls them by name. Nothing is built or loaded at
import: the first launch builds the library with nvcc.

  K1f harmonic.fused_harmonic_synthesis  <- ddsp_tpu harmonic.py:_fwd_kernel
  K1t   its backward, amplitude taps     <- harmonic.py:_bwd_taps_kernel
  K1p   its backward, phase              <- harmonic.py:_bwd_phase_kernel
  K2f gru.gru_sequence                   <- ddsp_tpu gru.py:_fwd_kernel
  K2b   its backward                     <- gru.py:_bwd_kernel
  K3  halo.HaloShift (both directions)   <- ddsp_tpu pallas_halo.py:_shift_kernel
        between ranks, the remote copy   <- its make_async_remote_copy
"""

from ddsp_torch.kernels import gru, halo, harmonic

__all__ = ['gru', 'halo', 'harmonic']
