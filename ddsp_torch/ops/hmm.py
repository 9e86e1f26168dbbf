"""Hidden Markov model primitives: forward log-likelihood and Viterbi.

Port of ddsp_tpu/ops/hmm.py, whose lax.scans become loops over time of
batched [B, S, S] reductions on the observations' device. The observation
model is given as per-step log-likelihoods [batch, time, n_states], so any
emission distribution plugs in.
"""

from __future__ import annotations

import numpy as np
import torch


def forward_log_prob(log_initial: torch.Tensor, log_transition: torch.Tensor,
                     obs_ll: torch.Tensor) -> torch.Tensor:
  """Marginal log-likelihood of observations via the forward algorithm.

  Args:
    log_initial: Log initial state distribution, [n_states].
    log_transition: Log transition matrix, [n_states, n_states]
      (rows = from-state).
    obs_ll: Per-step observation log-likelihoods, [batch, time, n_states].

  Returns:
    log p(observations), shape [batch].
  """
  log_alpha = log_initial + obs_ll[:, 0]
  for t in range(1, obs_ll.shape[1]):
    # logsumexp over the from-state axis.
    log_alpha = torch.logsumexp(log_alpha[:, :, None] + log_transition,
                                dim=1) + obs_ll[:, t]
  return torch.logsumexp(log_alpha, dim=-1)


def viterbi_decode(log_initial: torch.Tensor, log_transition: torch.Tensor,
                   obs_ll: torch.Tensor) -> torch.Tensor:
  """Most likely state sequence (posterior mode).

  The forward pass runs on the observations' device; the backtrace runs on
  the host over the stacked back-pointers (one copy of [time - 1, batch,
  n_states] int16).

  Args:
    log_initial: [n_states].
    log_transition: [n_states, n_states].
    obs_ll: [batch, time, n_states].

  Returns:
    State indices, int32 [batch, time], on the observations' device.
  """
  batch, n_steps, _ = obs_ll.shape
  delta = log_initial + obs_ll[:, 0]
  backptrs = []
  for t in range(1, n_steps):
    # scores[b, i, j] = delta[b, i] + log_transition[i, j]
    scores = delta[:, :, None] + log_transition
    # torch.argmax returns the first maximal index on both devices, as
    # jnp.argmax does; ties are common under CREPE's symmetric transitions,
    # so this choice decides the path.
    backptrs.append(torch.argmax(scores, dim=1).to(torch.int16))
    delta = torch.amax(scores, dim=1) + obs_ll[:, t]
  last = torch.argmax(delta, dim=-1).cpu().numpy()

  states = np.empty((n_steps, batch), np.int32)
  states[-1] = last
  if backptrs:
    pointers = torch.stack(backptrs).cpu().numpy()
    rows = np.arange(batch)
    for t in range(n_steps - 2, -1, -1):
      states[t] = pointers[t, rows, states[t + 1]]
  return torch.from_numpy(states.T.copy()).to(obs_ll.device)


def gaussian_obs_log_prob(observations: torch.Tensor, locs: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
  """Diagonal-gaussian observation log-likelihoods for every state.

  Args:
    observations: [batch, time, obs_dim].
    locs: Per-state means, [n_states, obs_dim].
    scales: Per-state stddevs, [n_states, obs_dim].

  Returns:
    Log-likelihoods, [batch, time, n_states].
  """
  z = (observations[:, :, None, :] - locs) / scales
  log_2pi = 1.8378770664093453
  ll = -0.5 * (z * z + log_2pi) - torch.log(scales)
  return torch.sum(ll, dim=-1)
