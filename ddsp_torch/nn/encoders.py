"""Encoders: audio or features -> a latent z or synthesizer controls.

Port of ddsp_tpu/nn/encoders.py. Submodules keep flax's names (z_norm,
rnn, dense_out, ...), so a JAX parameter tree loads as it is. Where the JAX
encoder takes a `net` module, the port takes a torch module whose
`out_features` is its output width (the port's FcStack, Rnn, RnnSandwich,
... carry it); widths flax infers at its first call are constructor
arguments here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ddsp_torch.nn import layers as nn_layers
from ddsp_torch.nn.resnet import ResNet
from ddsp_torch.ops import core as ops_core
from ddsp_torch.ops import oscillator, spectral
from ddsp_torch.ops.resample import resample

# fft_size and overlap that land the MFCC frames at z_time_steps for 4 s of
# 16 kHz audio (the reference's encoders.py:79-100).
_Z_AUDIO_SPEC = {
    63: dict(fft_size=2048, overlap=0.5),
    125: dict(fft_size=1024, overlap=0.5),
    250: dict(fft_size=1024, overlap=0.75),
    500: dict(fft_size=512, overlap=0.75),
    1000: dict(fft_size=256, overlap=0.75),
}
_MFCC_BINS = 30


class ZEncoder(nn_layers.DictModule):
  """A latent z resampled to the conditioning's time steps.

  Subclasses implement compute_z(*inputs). The last declared input
  ('f0_scaled' by convention) only gives the number of time steps.
  """

  def __init__(self, output_keys: Tuple[str, ...] = ('z',)):
    super().__init__()
    self.output_keys = tuple(output_keys)

  def compute(self, *args):
    time_steps = int(args[-1].shape[1])
    return (self.expand_z(self.compute_z(*args[:-1]), time_steps),)

  @staticmethod
  def expand_z(z: torch.Tensor, time_steps: int) -> torch.Tensor:
    """z [batch, (frames,) z_dims] at `time_steps` frames (linear)."""
    if z.ndim == 2:
      z = z[:, None, :]
    if int(z.shape[1]) != time_steps:
      z = resample(z, time_steps)
    return z

  def compute_z(self, *inputs) -> torch.Tensor:
    raise NotImplementedError


def _normalized_mfccs(norm: nn.Module, audio: torch.Tensor, **kwargs):
  """Instance-normalized MFCCs [batch, frames, mfcc_bins] of the audio."""
  mfccs = spectral.compute_mfcc(audio, lo_hz=20.0, hi_hz=8000.0, **kwargs)
  return norm(mfccs[:, :, None, :])[:, :, 0, :]


class MfccTimeDistributedRnnEncoder(ZEncoder):
  """MFCCs -> instance norm (z_norm) -> RNN (rnn) -> Dense (dense_out): a
  latent z per MFCC frame, resampled to the conditioning's frames.

  The RNN runs in bf16 whatever the model's compute_dtype, as the JAX
  encoder builds its Rnn with the default (ddsp_tpu/nn/encoders.py:84): on
  the card its FastGRU is kernel K2 at T = the MFCC frames.
  """

  def __init__(self, rnn_channels: int = 512, rnn_type: str = 'gru',
               z_dims: int = 32, z_time_steps: int = 250,
               input_keys: Tuple[str, ...] = ('audio', 'f0_scaled'),
               output_keys: Tuple[str, ...] = ('z',)):
    super().__init__(output_keys)
    self.input_keys = tuple(input_keys)
    if z_time_steps not in _Z_AUDIO_SPEC:
      raise ValueError('`z_time_steps` currently limited to '
                       f'{sorted(_Z_AUDIO_SPEC)}')
    spec = _Z_AUDIO_SPEC[z_time_steps]
    self.fft_size = spec['fft_size']
    self.overlap = spec['overlap']
    self.z_norm = nn_layers.Normalize(_MFCC_BINS, 'instance')
    self.rnn = nn_layers.Rnn(_MFCC_BINS, rnn_channels, rnn_type)
    self.dense_out = nn_layers.Dense(rnn_channels, z_dims)

  def compute_z(self, audio: torch.Tensor) -> torch.Tensor:
    z = _normalized_mfccs(self.z_norm, audio, fft_size=self.fft_size,
                          mel_bins=128, mfcc_bins=_MFCC_BINS,
                          overlap=self.overlap, pad_end=True)
    return self.dense_out(self.rnn(z))


class OneHotEncoder(ZEncoder):
  """An embedding of an integer instrument or class id as the latent z."""

  def __init__(self, vocab_size: int = 1, z_dims: int = 32,
               input_keys: Tuple[str, ...] = ('instrument_id', 'f0_scaled'),
               output_keys: Tuple[str, ...] = ('z',)):
    super().__init__(output_keys)
    self.input_keys = tuple(input_keys)
    self.embedding = nn_layers.Embed(vocab_size, z_dims)

  def compute_z(self, instrument_id: torch.Tensor) -> torch.Tensor:
    ids = torch.as_tensor(instrument_id).long()
    if ids.ndim == 1:
      ids = ids[:, None]
    return self.embedding(ids)


class AggregateFeaturesEncoder(ZEncoder):
  """The mean over time of a Dense (fc) of (f0, loudness)."""

  def __init__(self, ch: int = 512, in_features: int = 2,
               input_keys: Tuple[str, ...] = ('f0_scaled', 'ld_scaled'),
               output_keys: Tuple[str, ...] = ('z',)):
    super().__init__(output_keys)
    self.input_keys = tuple(input_keys)
    self.fc = nn_layers.Dense(in_features, ch)

  def compute(self, *args):
    # Every declared input feeds compute_z; the first gives the time steps.
    time_steps = int(args[0].shape[1])
    return (self.expand_z(self.compute_z(*args), time_steps),)

  def compute_z(self, f0_scaled, ld_scaled) -> torch.Tensor:
    x = torch.cat([f0_scaled, ld_scaled], dim=-1)
    return torch.mean(self.fc(x), dim=1, keepdim=True)


class MfccEncoder(ZEncoder):
  """Instance-normalized MFCCs (several resolutions, concatenated) as z."""

  def __init__(self, fft_sizes: Sequence[int] = (1024,),
               mel_bins: Sequence[int] = (128,),
               mfcc_bins: Sequence[int] = (30,), time_steps: int = 250,
               input_keys: Tuple[str, ...] = ('audio', 'f0_scaled'),
               output_keys: Tuple[str, ...] = ('z',)):
    super().__init__(output_keys)
    self.input_keys = tuple(input_keys)
    self.fft_sizes = tuple(fft_sizes)
    self.mel_bins = tuple(mel_bins)
    self.mfcc_bins = tuple(mfcc_bins)
    self.time_steps = time_steps
    self.norm_out = nn_layers.Normalize(sum(self.mfcc_bins), 'instance')

  def compute_z(self, audio: torch.Tensor) -> torch.Tensor:
    mfccs = [resample(spectral.compute_mfcc(audio, lo_hz=20.0, hi_hz=8000.0,
                                            fft_size=fft_size,
                                            mel_bins=mel_bin,
                                            mfcc_bins=mfcc_bin),
                      self.time_steps)
             for fft_size, mel_bin, mfcc_bin in zip(
                 self.fft_sizes, self.mel_bins, self.mfcc_bins)]
    mfccs = torch.cat(mfccs, dim=-1)
    return self.norm_out(mfccs[:, :, None, :])[:, :, 0, :]


class MfccRnnEncoder(ZEncoder):
  """MFCCs -> instance norm -> RNN -> Dense: one z for the whole clip (the
  last step, or the mean over time with mean_aggregate)."""

  def __init__(self, rnn_channels: int = 512, rnn_type: str = 'gru',
               z_dims: int = 512, mean_aggregate: bool = False,
               input_keys: Tuple[str, ...] = ('audio', 'f0_scaled'),
               output_keys: Tuple[str, ...] = ('z',)):
    super().__init__(output_keys)
    self.input_keys = tuple(input_keys)
    self.mean_aggregate = mean_aggregate
    self.norm_in = nn_layers.Normalize(_MFCC_BINS, 'instance')
    self.rnn = nn_layers.Rnn(_MFCC_BINS, rnn_channels, rnn_type,
                             return_sequences=mean_aggregate)
    self.dense_z = nn_layers.Dense(rnn_channels, z_dims)

  def compute_z(self, audio: torch.Tensor) -> torch.Tensor:
    z = _normalized_mfccs(self.norm_in, audio, fft_size=1024, mel_bins=128,
                          mfcc_bins=_MFCC_BINS)
    if self.mean_aggregate:
      z = torch.mean(self.rnn(z), dim=1, keepdim=True)
    else:
      z = self.rnn(z)[:, None, :]  # the last step only
    return self.dense_z(z)


class _MidiHead(nn_layers.DictModule):
  """net -> Normalize('layer') (norm) -> Dense to 2 (dense_out): (z_pitch,
  z_vel), z_pitch plus f0_midi with f0_residual."""

  def __init__(self, net: Optional[nn.Module], f0_residual: bool,
               input_keys: Tuple[str, ...], output_keys: Tuple[str, ...]):
    super().__init__()
    self.net = nn_layers.required_net(net, type(self).__name__)
    self.f0_residual = f0_residual
    self.input_keys = tuple(input_keys)
    self.output_keys = tuple(output_keys)
    self.dense_out = nn_layers.Dense(net.out_features, 2)
    self.norm = nn_layers.Normalize(net.out_features, 'layer')

  def compute(self, f0_midi, *features):
    x = self.net(torch.cat([f0_midi] + list(features), dim=-1))
    x = self.dense_out(self.norm(x))
    z_pitch, z_vel = x[..., 0:1], x[..., 1:2]
    if self.f0_residual:
      z_pitch = z_pitch + f0_midi
    return z_pitch, z_vel


class MidiEncoder(_MidiHead):
  """f0 and loudness curves -> (unquantized) MIDI pitch and velocity."""

  def __init__(self, net: Optional[nn.Module] = None,
               f0_residual: bool = True,
               input_keys: Tuple[str, ...] = ('f0_midi', 'loudness'),
               output_keys: Tuple[str, ...] = ('z_pitch', 'z_vel')):
    super().__init__(net, f0_residual, input_keys, output_keys)


class HarmonicToMidiEncoder(_MidiHead):
  """Harmonic synth parameters -> MIDI pitch and velocity."""

  def __init__(self, net: Optional[nn.Module] = None,
               f0_residual: bool = True,
               input_keys: Tuple[str, ...] = ('f0_midi', 'amps', 'hd',
                                              'noise'),
               output_keys: Tuple[str, ...] = ('z_pitch', 'z_vel')):
    super().__init__(net, f0_residual, input_keys, output_keys)


class ExpressionEncoder(ZEncoder):
  """A latent from loudness and pitch features, and MFCCs of the audio
  when 'audio' is among input_keys: net -> Normalize('layer') (norm) ->
  Dense (dense_out), pooled over time with pool_time.

  in_features is the width of the non-audio inputs together (flax infers
  the net's input width; the caller's net takes it plus mfcc_bins with
  audio).
  """

  def __init__(self, net: Optional[nn.Module] = None, z_dims: int = 128,
               input_keys: Tuple[str, ...] = ('f0_scaled', 'ld_scaled'),
               mfcc_bins: int = 60, fft_size: int = 1024,
               mel_bins: int = 128, pool_time: bool = True,
               output_keys: Tuple[str, ...] = ('z',)):
    super().__init__(output_keys)
    self.net = net = nn_layers.required_net(net, 'ExpressionEncoder')
    self.input_keys = tuple(input_keys)
    self.mfcc_bins = mfcc_bins
    self.fft_size = fft_size
    self.mel_bins = mel_bins
    self.pool_time = pool_time
    self.norm = nn_layers.Normalize(net.out_features, 'layer')
    self.dense_out = nn_layers.Dense(net.out_features, z_dims)
    if 'audio' in self.input_keys:
      self.norm_mfcc = nn_layers.Normalize(mfcc_bins, 'instance')

  def compute(self, *args):
    # Every declared input feeds compute_z; the first non-audio input gives
    # the time steps.
    non_audio = [x for k, x in zip(self.input_keys, args) if k != 'audio']
    time_steps = int(non_audio[0].shape[1])
    return (self.expand_z(self.compute_z(*args), time_steps),)

  def compute_z(self, *inputs) -> torch.Tensor:
    inputs = list(inputs)
    if 'audio' in self.input_keys:
      audio = inputs.pop(self.input_keys.index('audio'))
      mfccs = spectral.compute_mfcc(audio, lo_hz=20.0, hi_hz=8000.0,
                                    fft_size=self.fft_size,
                                    mel_bins=self.mel_bins,
                                    mfcc_bins=self.mfcc_bins)
      inputs.append(resample(self.norm_mfcc(mfccs), int(inputs[0].shape[1])))
    z = self.dense_out(self.norm(self.net(torch.cat(inputs, dim=-1))))
    if self.pool_time:
      z = torch.mean(z, dim=1, keepdim=True)
    return z


class SinusoidalToHarmonicEncoder(nn_layers.DictModule):
  """Harmonic controls (amplitude, distribution, f0) from sinusoidal ones:
  net, then Dense heads amp_out, hd_out and f0_out (frequencies_softmax
  over f0_depth bins); the distribution loses what lies above Nyquist."""

  def __init__(self, net: Optional[nn.Module] = None,
               n_harmonics: int = 100, f0_depth: int = 64,
               hz_min: float = 20.0, hz_max: float = 1200.0,
               sample_rate: int = 16000,
               input_keys: Tuple[str, ...] = ('sin_freqs', 'sin_amps'),
               output_keys: Tuple[str, ...] = ('harm_amp', 'harm_dist',
                                               'f0_hz')):
    super().__init__()
    self.net = net = nn_layers.required_net(net, 'SinusoidalToHarmonicEncoder')
    self.input_keys = tuple(input_keys)
    self.output_keys = tuple(output_keys)
    self.f0_depth = f0_depth
    self.hz_min = hz_min
    self.hz_max = hz_max
    self.sample_rate = sample_rate
    self.amp_out = nn_layers.Dense(net.out_features, 1)
    self.hd_out = nn_layers.Dense(net.out_features, n_harmonics)
    self.f0_out = nn_layers.Dense(net.out_features, f0_depth)

  def compute(self, sin_freqs, sin_amps):
    sin_freqs_unit = ops_core.hz_to_unit(sin_freqs, hz_min=0.0,
                                         hz_max=self.sample_rate / 2.0)
    x = self.net(torch.cat([sin_freqs_unit, sin_amps], dim=-1))
    x = x['out'] if isinstance(x, dict) else x
    harm_amp = ops_core.exp_sigmoid(self.amp_out(x))
    harm_dist = ops_core.exp_sigmoid(self.hd_out(x))
    f0_hz = ops_core.frequencies_softmax(self.f0_out(x), depth=self.f0_depth,
                                         hz_min=self.hz_min,
                                         hz_max=self.hz_max)
    harm_dist = oscillator.normalize_harmonics(harm_dist, f0_hz,
                                               self.sample_rate)
    return harm_amp, harm_dist, f0_hz


class ResnetSinusoidalEncoder(nn_layers.DictModule):
  """Audio -> log mel (229 bins) -> ResNet -> one Dense head per output
  (dense_<name>): sinusoidal controls straight from audio."""

  def __init__(self, output_splits: Tuple[Tuple[str, int], ...] = (
      ('frequencies', 100 * 64), ('amplitudes', 100),
      ('noise_magnitudes', 60)), size: str = 'tiny',
               input_keys: Tuple[str, ...] = ('audio',)):
    super().__init__()
    self.output_splits = tuple(output_splits)
    self.input_keys = tuple(input_keys)
    # 'tiny' is the reference's small ResNet.
    self.resnet = ResNet(size='small' if size == 'tiny' else size)
    # 229 mel bins: /2 (stem) /2 (pool) and /2 /2 /2 (strides), rounded up.
    n_freq = 229
    for _ in range(5):
      n_freq = -(-n_freq // 2)
    in_features = n_freq * self.resnet.out_features
    for name, size_out in self.output_splits:
      self.add_module(f'dense_{name}', nn_layers.Dense(in_features, size_out))

  fft_size = 1024
  overlap = 0.75

  def n_frames(self, n_samples: int) -> int:
    """Frames of the log mel (and so of every output) for n_samples of
    audio: ceil(n_samples / hop), 250 at 4 s."""
    hop = int(self.fft_size * (1.0 - self.overlap))
    return -(-n_samples // hop)

  def compute(self, audio):
    mag = spectral.compute_logmel(audio, lo_hz=0.0, hi_hz=8000.0, bins=229,
                                  fft_size=self.fft_size,
                                  overlap=self.overlap)
    x = self.resnet(mag[:, :, :, None])
    x = x.reshape(x.shape[0], x.shape[1], -1)
    return {name: getattr(self, f'dense_{name}')(x)
            for name in self._output_keys()}

  def _output_keys(self) -> Sequence[str]:
    return [v[0] for v in self.output_splits]
