"""Differentiable DSP ops on torch tensors (port of ddsp_tpu.ops)."""

from ddsp_torch.ops import (core, crepe, fftconv, hmm, oscillator, resample,
                            spectral, synth_convert)

__all__ = ['core', 'crepe', 'fftconv', 'hmm', 'oscillator', 'resample',
           'spectral', 'synth_convert']
