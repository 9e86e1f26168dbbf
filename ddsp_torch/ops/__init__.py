"""Differentiable DSP ops on torch tensors (port of ddsp_tpu.ops).

A flat namespace, as the JAX package's (magenta's `ddsp.core` and
`ddsp.spectral_ops`): `from ddsp_torch import ops; ops.fft_convolve(...)`
works for every name that `ddsp_tpu.ops` exports. `ops.resample` is the
function, as in JAX; its module stays importable
(`from ddsp_torch.ops.resample import resample`). Nothing here builds a
kernel: the CUDA kernels are built at their first launch.
"""

# pylint: disable=wildcard-import,g-importing-member
from ddsp_torch.ops import (core, crepe, fftconv, hmm, oscillator, spectral,
                            synth_convert, wavetable)
from ddsp_torch.ops.core import *  # noqa: F401,F403
from ddsp_torch.ops.core import __all__ as _core_names
from ddsp_torch.ops.crepe import CrepeModel, PretrainedCrepe
from ddsp_torch.ops.fftconv import (apply_window_to_impulse_response,
                                    crop_and_compensate_delay, fft_convolve,
                                    frame, frequency_filter,
                                    frequency_impulse_response, get_fft_size,
                                    overlap_and_add, sinc, sinc_filter,
                                    sinc_impulse_response)
from ddsp_torch.ops.oscillator import (angular_cumsum,
                                       get_harmonic_frequencies,
                                       harmonic_oscillator_bank,
                                       harmonic_synthesis,
                                       normalize_harmonics, oscillator_bank,
                                       remove_above_nyquist,
                                       streaming_harmonic_synthesis)
from ddsp_torch.ops.resample import (center_crop, resample,
                                     upsample_with_windows)
from ddsp_torch.ops.spectral import (compute_f0, compute_logmag,
                                     compute_logmel, compute_loudness,
                                     compute_mag, compute_mel, compute_mfcc,
                                     compute_power, compute_rms_energy,
                                     get_framed_lengths,
                                     pad_or_trim_to_expected_length,
                                     reset_crepe, stft, stft_np)
from ddsp_torch.ops.synth_convert import (harmonic_to_sinusoidal,
                                          sinusoidal_to_harmonic)
from ddsp_torch.ops.wavetable import (harmonic_distribution_to_wavetable,
                                      linear_lookup, variable_length_delay,
                                      wavetable_synthesis)

__all__ = sorted(set(_core_names) | {
    'core', 'crepe', 'fftconv', 'hmm', 'oscillator', 'spectral',
    'synth_convert', 'wavetable', 'CrepeModel', 'PretrainedCrepe',
    'apply_window_to_impulse_response', 'crop_and_compensate_delay',
    'fft_convolve', 'frame', 'frequency_filter',
    'frequency_impulse_response', 'get_fft_size', 'overlap_and_add', 'sinc',
    'sinc_filter', 'sinc_impulse_response', 'angular_cumsum',
    'get_harmonic_frequencies', 'harmonic_oscillator_bank',
    'harmonic_synthesis', 'normalize_harmonics', 'oscillator_bank',
    'remove_above_nyquist', 'streaming_harmonic_synthesis', 'center_crop',
    'resample', 'upsample_with_windows', 'compute_f0', 'compute_logmag',
    'compute_logmel', 'compute_loudness', 'compute_mag', 'compute_mel',
    'compute_mfcc', 'compute_power', 'compute_rms_energy',
    'get_framed_lengths', 'pad_or_trim_to_expected_length', 'reset_crepe',
    'stft', 'stft_np', 'harmonic_to_sinusoidal', 'sinusoidal_to_harmonic',
    'harmonic_distribution_to_wavetable', 'linear_lookup',
    'variable_length_delay', 'wavetable_synthesis'})
