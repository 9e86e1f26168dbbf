"""Differentiable DSP ops on torch tensors (port of ddsp_tpu.ops)."""

from ddsp_torch.ops import core, fftconv, oscillator, resample, spectral

__all__ = ['core', 'fftconv', 'oscillator', 'resample', 'spectral']
