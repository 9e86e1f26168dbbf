"""HMM pitch -> MIDI transcriber: an NLL loss and the Viterbi MIDI decode.

Port of ddsp_tpu/losses/hmm_transcriber.py. One hidden state per MIDI
pitch plus an "off" state (state 0); (pitch, amp) observations are
diagonal gaussians; transitions are peaked on the diagonal with an
expected note length `avg_length`. The tables are buffers, so `.to()`
moves them; the forward algorithm and the Viterbi decode are
ops/hmm.py's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ddsp_torch.losses.spectral import Loss
from ddsp_torch.ops import hmm


class HmmTranscriber(Loss):
  """HMM for decoding MIDI from pitch (MIDI) and amplitude trajectories.

  States: 0 = note off (broad pitch prior, low amp), 1..n_pitches-1 = the
  MIDI pitch (tight pitch gaussian, "on" amp). Build it with `create`.
  """

  def __init__(self, log_initial: torch.Tensor, log_transition: torch.Tensor,
               obs_locs: torch.Tensor, obs_scales: torch.Tensor,
               n_pitches: int = 128, weight: float = 1.0,
               name: Optional[str] = None):
    super().__init__(name)
    self.register_buffer('log_initial', log_initial)
    self.register_buffer('log_transition', log_transition)
    self.register_buffer('obs_locs', obs_locs)
    self.register_buffer('obs_scales', obs_scales)
    self.n_pitches = n_pitches
    self.weight = weight

  @classmethod
  def create(cls, avg_length: float = 200, midi_std: float = 0.5,
             amps_on_center: float = 1.5, amps_on_scale: float = 0.5,
             amps_off_center: float = 0.0, amps_off_scale: float = 0.1,
             n_pitches: int = 128, weight: float = 1.0) -> 'HmmTranscriber':
    # A uniform initial distribution.
    log_initial = torch.full((n_pitches,), -np.log(n_pitches),
                             dtype=torch.float32)

    # Transitions heavily peaked on the diagonal: hold with probability
    # 1 - 1/avg_length, otherwise uniform over the other states.
    hold = 1.0 - 1.0 / avg_length
    other = (1.0 - hold) / (n_pitches - 1)
    transitions = ((hold - other) * np.eye(n_pitches) +
                   other * np.ones((n_pitches, n_pitches)))
    transitions /= transitions.sum(axis=1, keepdims=True)
    log_transition = torch.log(torch.from_numpy(
        transitions.astype(np.float32)))

    # Observation gaussians over (pitch_midi, amp). State 0 ("off") has a
    # broad pitch prior centered mid-range and a near-zero amp.
    p_loc = np.arange(1, n_pitches, dtype=np.float32)
    pitch_loc = np.concatenate([[n_pitches / 2.0], p_loc])
    pitch_scale = np.concatenate([[float(n_pitches)],
                                  np.full(n_pitches - 1, midi_std)])
    amps_loc = np.concatenate([[amps_off_center],
                               np.full(n_pitches - 1, amps_on_center)])
    amps_scale = np.concatenate([[amps_off_scale],
                                 np.full(n_pitches - 1, amps_on_scale)])
    obs_locs = torch.from_numpy(
        np.stack([pitch_loc, amps_loc], axis=-1).astype(np.float32))
    obs_scales = torch.from_numpy(
        np.stack([pitch_scale, amps_scale], axis=-1).astype(np.float32))
    return cls(log_initial, log_transition, obs_locs, obs_scales,
               n_pitches=n_pitches, weight=weight)

  def _obs_ll(self, pitch: torch.Tensor, amps: torch.Tensor) -> torch.Tensor:
    pa = torch.cat([pitch, amps], dim=-1)
    return hmm.gaussian_obs_log_prob(pa, self.obs_locs, self.obs_scales)

  def log_prob(self, pitch: torch.Tensor, amps: torch.Tensor) -> torch.Tensor:
    """log p(pitch, amps) per example; inputs [batch, time, 1]."""
    return hmm.forward_log_prob(self.log_initial, self.log_transition,
                                self._obs_ll(pitch, amps))

  def forward(self, pitch: torch.Tensor, amps: torch.Tensor) -> torch.Tensor:
    return self.nll(pitch, amps)

  def nll(self, pitch: torch.Tensor, amps: torch.Tensor,
          per_example_loss: bool = False) -> torch.Tensor:
    """Negative log-likelihood per time step."""
    avg_nll = -self.log_prob(pitch, amps) / pitch.shape[1]
    loss = avg_nll if per_example_loss else torch.mean(avg_nll)
    return self.weight * loss

  def get_losses_dict(self, pitch: torch.Tensor, amps: torch.Tensor):
    return {'hmm_nll': self.nll(pitch, amps)}

  @staticmethod
  def straight_through(x: torch.Tensor, x_quant: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward x_quant, gradient of x."""
    return x - (x - x_quant).detach()

  @torch.no_grad()
  def predict_midi(self, pitch: torch.Tensor, amps: torch.Tensor,
                   channel_dim: bool = True,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Viterbi decode of the most likely state as quantized MIDI."""
    q_pitch = hmm.viterbi_decode(self.log_initial, self.log_transition,
                                 self._obs_ll(pitch, amps)).to(dtype)
    if channel_dim:
      q_pitch = q_pitch[:, :, None]
    return q_pitch
