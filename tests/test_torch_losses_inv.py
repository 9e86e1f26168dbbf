"""The consistency, TWM, HMM-transcriber and CREPE-embedding losses of
ddsp_torch against ddsp_tpu's, values and gradients, on the CPU.

The same numpy inputs (made from a seed) go through the JAX loss and the
port's. Tolerances:
- values rtol 1e-5 (float32 reductions in two libraries; logsumexp over
  mixture components sums in another order);
- gradients, relative L2 of each input's gradient 1e-4 (elementwise
  float32 chains; the L1 terms' sign() agrees where no difference is
  within a rounding of zero, and the data keep them apart);
- the Wasserstein distance also against scipy.stats.wasserstein_distance
  (float64) at rtol 1e-4, the JAX test's tolerance;
- the TWM f0 and the HMM's MIDI decode: equal;
- CREPE's embedding: values rtol 1e-4, gradients relative L2 1e-3 (six
  convolutions of 1024 samples, oneDNN's and XLA's sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from ddsp_tpu import losses as j_losses
from ddsp_tpu.ops import crepe as j_crepe
from ddsp_torch import losses as t_losses

torch.set_num_threads(1)

RTOL = 1e-5
GRAD_RTOL = 1e-4


def _rel(got, want):
  return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _compare(j_fn, t_fn, inputs, rtol=RTOL, grad_rtol=GRAD_RTOL,
             wrt=None):
  """Values of j_fn and t_fn on the numpy inputs, and the gradients of
  their sum with respect to the inputs named in wrt (all by default)."""
  wrt = list(inputs) if wrt is None else wrt
  j_in = {k: jnp.asarray(v) for k, v in inputs.items()}

  def j_total(diff):
    return jnp.sum(j_fn(**dict(j_in, **diff)))

  want = np.asarray(jax.jit(lambda kw: j_fn(**kw))(j_in))
  grads_j = jax.jit(jax.grad(j_total))({k: j_in[k] for k in wrt})
  t_in = {k: torch.from_numpy(np.array(v)).requires_grad_(k in wrt)
          for k, v in inputs.items()}
  got = t_fn(**t_in)
  np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                             atol=rtol)
  grads_t = torch.autograd.grad(got.sum(), [t_in[k] for k in wrt])
  for k, g in zip(wrt, grads_t):
    g_j = np.asarray(grads_j[k])
    assert np.linalg.norm(g_j) > 0, k
    assert _rel(g.numpy(), g_j) <= grad_rtol, (k, _rel(g.numpy(), g_j))


def _sinusoids(seed, b=2, t=5, k=8):
  """Amplitudes in (0.05, 1.05) and frequencies of 80-4000 Hz."""
  rng = np.random.RandomState(seed)
  amps = (rng.rand(b, t, k) + 0.05).astype(np.float32)
  freqs = (80.0 * 50.0**rng.rand(b, t, k)).astype(np.float32)
  return amps, freqs


# --- Gaussian mixtures, amplitude and frequency losses ---------------------

def test_mixture_log_prob_matches_jax():
  rng = np.random.RandomState(0)
  inputs = {'x': (rng.randn(2, 3, 7) * 3 + 60).astype(np.float32),
            'probs': rng.dirichlet(np.ones(5), (2, 3)).astype(np.float32),
            'locs': (rng.randn(2, 3, 5) * 3 + 60).astype(np.float32)}
  _compare(lambda **kw: j_losses.mixture_log_prob(**kw, scale=0.7),
           lambda **kw: t_losses.mixture_log_prob(**kw, scale=0.7), inputs)
  x = inputs['x'][0, 0]
  _compare(lambda x: j_losses.normal_log_prob(x, 60.0, 2.0),
           lambda x: t_losses.normal_log_prob(x, 60.0, 2.0), {'x': x})


@pytest.mark.parametrize('log', [False, True])
def test_amp_and_freq_losses_match_jax(log):
  amps, freqs = _sinusoids(1)
  amps_t, freqs_t = _sinusoids(2)
  weights = (np.random.RandomState(3).rand(*amps.shape) > 0.3).astype(
      np.float32)
  _compare(lambda a, b, w: j_losses.amp_loss(a, b, weights=w, log=log),
           lambda a, b, w: t_losses.amp_loss(a, b, weights=w, log=log),
           {'a': amps, 'b': amps_t, 'w': weights}, wrt=['a', 'b'])
  _compare(lambda a, b: j_losses.freq_loss(a, b, loss_type='L2'),
           lambda a, b: t_losses.freq_loss(a, b, loss_type='L2'),
           {'a': freqs, 'b': freqs_t})


# --- Wasserstein ------------------------------------------------------------

def _ties(seed, b=2, t=3, k=8):
  """Values on a grid of 0.5 (ties within and across the two samples)."""
  rng = np.random.RandomState(seed)
  return (0.5 * rng.randint(0, 8, size=(b, t, k))).astype(np.float32)


@pytest.mark.parametrize('weighted', [False, True])
def test_wasserstein_distance_matches_jax_and_scipy(weighted):
  """With tied values (searchsorted's side='right' and the stable sorts
  decide the CDFs and where the gradients go)."""
  u, v = _ties(4), _ties(5)
  rng = np.random.RandomState(6)
  inputs = {'u': u, 'v': v}
  if weighted:
    inputs.update(uw=(rng.rand(*u.shape) + 0.1).astype(np.float32),
                  vw=(rng.rand(*v.shape) + 0.1).astype(np.float32))
  j_fn = lambda u, v, uw=None, vw=None: j_losses.wasserstein_distance(
      u, v, uw, vw)
  t_fn = lambda u, v, uw=None, vw=None: t_losses.wasserstein_distance(
      u, v, uw, vw)
  _compare(j_fn, t_fn, inputs)
  got = t_fn(*(torch.from_numpy(x) for x in inputs.values())).numpy()
  for i in np.ndindex(*u.shape[:-1]):
    args = [x[i] for x in inputs.values()]
    want = scipy.stats.wasserstein_distance(*args)
    np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-6)


def test_wasserstein_distance_p2_matches_jax():
  rng = np.random.RandomState(7)
  inputs = {'u': rng.randn(2, 9).astype(np.float32),
            'v': rng.randn(2, 9).astype(np.float32),
            'uw': (rng.rand(2, 9) + 0.1).astype(np.float32)}
  _compare(lambda u, v, uw: j_losses.wasserstein_distance(u, v, uw, p=2.0),
           lambda u, v, uw: t_losses.wasserstein_distance(u, v, uw, p=2.0),
           inputs)


# --- The consistency losses -------------------------------------------------

def _consistency_case(name):
  amps_a, freqs_a = _sinusoids(10)
  amps_b, freqs_b = _sinusoids(11)
  inputs = {'amps_a': amps_a, 'freqs_a': freqs_a, 'amps_b': amps_b,
            'freqs_b': freqs_b}
  if name == 'kde':
    kw = dict(weight_a=0.7, weight_b=1.3, weight_mean_amp=0.5, scale_a=0.3,
              scale_b=0.2)
    return (j_losses.KDEConsistencyLoss(**kw),
            t_losses.KDEConsistencyLoss(**kw), inputs)
  if name == 'wasserstein':
    return (j_losses.WassersteinConsistencyLoss(weight=0.5),
            t_losses.WassersteinConsistencyLoss(weight=0.5), inputs)
  assert name == 'filtered_noise'
  rng = np.random.RandomState(12)
  return (j_losses.FilteredNoiseConsistencyLoss(weight=2.0),
          t_losses.FilteredNoiseConsistencyLoss(weight=2.0),
          {'noise_magnitudes': rng.rand(2, 5, 9).astype(np.float32),
           'noise_magnitudes_target': rng.rand(2, 5, 9).astype(np.float32)})


@pytest.mark.parametrize('name', ['kde', 'wasserstein', 'filtered_noise'])
def test_consistency_loss_matches_jax(name):
  j_loss, t_loss, inputs = _consistency_case(name)
  _compare(lambda **kw: j_loss(**kw), lambda **kw: t_loss(**kw), inputs)


def test_harmonic_consistency_loss_matches_jax():
  """Each of the three terms; a quarter of the target's amplitudes under
  the threshold mask the distribution and f0 terms there."""
  rng = np.random.RandomState(13)
  amp = rng.rand(2, 6, 1).astype(np.float32)
  amp_t = np.where(rng.rand(2, 6, 1) < 0.25, 5e-5,
                   rng.rand(2, 6, 1)).astype(np.float32)
  inputs = {'harm_amp': amp, 'harm_amp_target': amp_t,
            'harm_dist': rng.dirichlet(np.ones(7), (2, 6)).astype(np.float32),
            'harm_dist_target': rng.dirichlet(np.ones(7), (2, 6)).astype(
                np.float32),
            'f0_hz': (100 + 300 * rng.rand(2, 6, 1)).astype(np.float32),
            'f0_hz_target': (100 + 300 * rng.rand(2, 6, 1)).astype(
                np.float32)}
  kw = dict(amp_weight=0.5, dist_weight=2.0, f0_weight=1.5)
  j_loss = j_losses.HarmonicConsistencyLoss(**kw)
  t_loss = t_losses.HarmonicConsistencyLoss(**kw)
  assert sorted(t_loss(**{k: torch.from_numpy(v)
                          for k, v in inputs.items()})) == [
                              'f0_hz_loss', 'harm_amp_loss', 'harm_dist_loss']
  for key, wrt in (('harm_amp_loss', 'harm_amp'),
                   ('harm_dist_loss', 'harm_dist'), ('f0_hz_loss', 'f0_hz')):
    _compare(lambda key=key, **kw: j_loss(**kw)[key],
             lambda key=key, **kw: t_loss(**kw)[key], inputs, wrt=[wrt])


# --- TWM --------------------------------------------------------------------

def _twm_inputs(seed=20, b=2, t=4, k=8):
  """Partials of a 150-300 Hz f0 (amplitude 1/h), detuned slightly, plus
  two inharmonic ones; the candidates are the partials themselves."""
  rng = np.random.RandomState(seed)
  f0 = 150.0 + 150.0 * rng.rand(b, t, 1)
  h = np.arange(1, k - 1)
  freqs = np.concatenate([f0 * h * (1 + 0.003 * rng.randn(b, t, k - 2)),
                          300.0 + 3000.0 * rng.rand(b, t, 2)], axis=-1)
  amps = np.concatenate([np.broadcast_to(1.0 / h, (b, t, k - 2)),
                         0.2 * rng.rand(b, t, 2)], axis=-1)
  return freqs.astype(np.float32), amps.astype(np.float32), f0


def test_twm_loss_matches_jax():
  freqs, amps, _ = _twm_inputs()
  kw = dict(sinusoids_weight=0.8, harmonics_weight=1.2,
            softmin_temperature=0.5, n_harmonic_points=6,
            n_harmonic_gaussians=12)
  j_loss, t_loss = j_losses.TWMLoss(**kw), t_losses.TWMLoss(**kw)
  inputs = {'f0_candidates': freqs.copy(), 'freqs': freqs, 'amps': amps}
  _compare(lambda **kw: j_loss(**kw), lambda **kw: t_loss(**kw), inputs)
  for i in range(2):
    _compare(lambda **kw: j_loss.get_loss_tensors(**kw)[i],
             lambda **kw: t_loss.get_loss_tensors(**kw)[i], inputs)


def test_twm_predict_f0_matches_jax():
  """The TWM f0 picks the fundamental among the partials, as the JAX one
  does, at the defaults (the evaluator's)."""
  freqs, amps, f0 = _twm_inputs(seed=21, b=3, t=6, k=10)
  want = j_losses.TWMLoss().predict_f0(freqs, freqs, amps)
  got = t_losses.TWMLoss().predict_f0(torch.from_numpy(freqs),
                                      torch.from_numpy(freqs),
                                      torch.from_numpy(amps))
  assert got.shape == (3, 6, 1)
  np.testing.assert_array_equal(got, want)
  np.testing.assert_allclose(got, f0, rtol=0.02)


# --- The HMM transcriber ----------------------------------------------------

def _pitch_amps(seed=30, b=2, t=40):
  """Two notes and a rest: MIDI pitch with jitter, amplitude on/off."""
  rng = np.random.RandomState(seed)
  notes = np.repeat(rng.randint(50, 70, size=(b, 3)), [15, 15, 10], axis=1)
  on = np.repeat(np.array([[1.0, 1.0, 0.0]]), [15, 15, 10], axis=1)
  pitch = notes + 0.2 * rng.randn(b, t)
  amps = on * 1.5 + 0.1 * rng.randn(b, t)
  return (pitch[..., None].astype(np.float32),
          amps[..., None].astype(np.float32))


def test_hmm_transcriber_matches_jax():
  kw = dict(avg_length=20, midi_std=0.7, n_pitches=96, weight=0.5)
  j_hmm = j_losses.HmmTranscriber.create(**kw)
  t_hmm = t_losses.HmmTranscriber.create(**kw)
  for name in ('log_initial', 'log_transition', 'obs_locs', 'obs_scales'):
    np.testing.assert_allclose(getattr(t_hmm, name).numpy(),
                               np.asarray(getattr(j_hmm, name)), rtol=RTOL,
                               err_msg=name)
  pitch, amps = _pitch_amps()
  _compare(lambda **kw: j_hmm(**kw), lambda **kw: t_hmm(**kw),
           {'pitch': pitch, 'amps': amps})
  _compare(lambda **kw: j_hmm.nll(**kw, per_example_loss=True),
           lambda **kw: t_hmm.nll(**kw, per_example_loss=True),
           {'pitch': pitch, 'amps': amps})
  losses = t_hmm.get_losses_dict(torch.from_numpy(pitch),
                                 torch.from_numpy(amps))
  assert sorted(losses) == ['hmm_nll']
  want = np.asarray(j_hmm.predict_midi(jnp.asarray(pitch), jnp.asarray(amps)))
  got = t_hmm.predict_midi(torch.from_numpy(pitch), torch.from_numpy(amps))
  assert got.shape == (2, 40, 1) and got.dtype == torch.float32
  np.testing.assert_array_equal(got.numpy(), want)
  assert (got.numpy()[:, 32:] == 0).all()  # the rest decodes to state 0


def test_straight_through_matches_jax():
  x = np.linspace(-2, 2, 9).astype(np.float32)
  q = np.round(x)
  _compare(lambda x: j_losses.HmmTranscriber.straight_through(x, q) * x,
           lambda x: t_losses.HmmTranscriber.straight_through(
               x, torch.from_numpy(q)) * x, {'x': x})


# --- CREPE embedding --------------------------------------------------------

def _jax_crepe_npz(path, layer):
  """JAX's randomly initialized CREPE variables (PRNGKey(0), the JAX
  loss's frozen variables without a weights_path), written as the port's
  .npz ('<collection>/<module>/<name>'). The whole network's: flax draws
  each layer's from its name, so the layers before `layer` are those of
  the JAX loss's truncated model, and the port's loader wants them all."""
  variables = j_crepe.CrepeModel(model_capacity='tiny').init(
      jax.random.PRNGKey(0), jnp.zeros((1, 1024)))
  truncated = j_crepe.CrepeModel(model_capacity='tiny',
                                 activation_layer=layer).init(
                                     jax.random.PRNGKey(0),
                                     jnp.zeros((1, 1024)))
  for col, mods in truncated.items():
    for mod, leaves in mods.items():
      for name, v in leaves.items():
        np.testing.assert_array_equal(np.asarray(variables[col][mod][name]),
                                      np.asarray(v))
  flat = {f'{col}/{mod}/{name}': np.asarray(v)
          for col, mods in variables.items() for mod, leaves in mods.items()
          for name, v in leaves.items()}
  np.savez(path, **flat)
  return str(path)


@pytest.mark.parametrize('layer', ['classifier', 'conv3-maxpool'])
def test_crepe_embedding_loss_matches_jax(tmp_path, layer):
  rng = np.random.RandomState(40)
  t = np.arange(2048) / 16000.0
  target = (0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.randn(2, 2048)
            ).astype(np.float32)
  audio = (0.3 * np.sin(2 * np.pi * 233.0 * t) + 0.05 * rng.randn(2, 2048)
           ).astype(np.float32)
  j_loss = j_losses.PretrainedCREPEEmbeddingLoss(activation_layer=layer,
                                                 weight=0.5)
  t_loss = t_losses.PretrainedCREPEEmbeddingLoss(
      activation_layer=layer, weight=0.5,
      weights_path=_jax_crepe_npz(tmp_path / 'model-tiny.npz', layer))
  assert t_loss.scale == j_loss.scale
  _compare(lambda **kw: j_loss(**kw), lambda **kw: t_loss(**kw),
           {'target_audio': target, 'audio': audio}, rtol=1e-4,
           grad_rtol=1e-3, wrt=['audio'])
  # Frozen and outside the module tree: no parameters, nothing to load.
  assert not list(t_loss.parameters()) and not t_loss.state_dict()
  assert not any(p.requires_grad
                 for p in t_loss.crepe_model('cpu').parameters())


def test_crepe_embedding_loss_needs_weights(monkeypatch, tmp_path):
  """The committed tiny weights by default; a capacity without weights
  raises naming its file; an unknown layer raises."""
  monkeypatch.setenv('CREPE_WEIGHTS_DIR', str(tmp_path))
  assert t_losses.PretrainedCREPEEmbeddingLoss().weights_path.endswith(
      'model-tiny.npz')
  with pytest.raises(FileNotFoundError, match='model-full.npz'):
    t_losses.PretrainedCREPEEmbeddingLoss(model_capacity='full')
  with pytest.raises(ValueError, match='conv9-BN'):
    t_losses.PretrainedCREPEEmbeddingLoss(activation_layer='conv9-BN')


def test_losses_export_the_jax_names():
  names = [n for n in dir(j_losses) if not n.startswith('_') and
           n[0].isalpha() and n not in ('consistency', 'crepe_embedding',
                                        'hmm_transcriber', 'spectral', 'twm')]
  assert sorted(names) == sorted(t_losses.__all__)
