"""Prefetch, training from TFRecords, export and serving of the port, on
the CPU.

Prefetch: order, the queue bound, a source's exception after the batches
before it, the batches in flight released on close and no thread started;
`train(prefetch=2)` against `train(prefetch=0)` from a TFRecordProvider
(bit-equal losses), and the prefetch closed when train() returns on a normal
exit, an early stop and an exception.

Training from centred records (n_samples / hop + 1 frames against the
model's time_steps): one step's losses against the JAX model on the same
batch, float32, rtol 1e-5 (the preprocessor resamples the extra frame as
the JAX one does). As in tests/test_torch_train.py the models use the
angular cumsum and a 100-200 Hz f0, and the records' audio and the synth
both carry a noise floor: the logmag term's gradient and its value near a
silent bin are 1/|bin|-conditioned, so two FFT libraries' last bits would
decide the comparison otherwise.

Export: `save_spec` writes the JAX package's JSON; the port's params.npz
from a port checkpoint holds the flax tree, which the JAX model applies
after the JAX `unflatten`; the JAX model's audio against the port's
AutoencoderInference on the export (float32, atol 4e-3, as
tests/test_torch_model.py holds serving), the train directory against the
export (bit for bit), the impulse response's wav against the JAX
`write_wav` (byte for byte), the formats the port does not convert to, and
fmt='params' refusing a vst train directory.
"""

import gc
import json
import threading
import wave
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.configs import presets as j_presets
from ddsp_tpu.eval.summaries import write_wav as j_write_wav
from ddsp_tpu.infer.export import unflatten as j_unflatten
from ddsp_tpu.utils import registry as j_registry
from ddsp_torch.data import SyntheticSinusoidProvider, TFRecordProvider
from ddsp_torch.data import prefetch
from ddsp_torch.data.tfrecord import write_examples
from ddsp_torch.eval.summaries import write_wav
from ddsp_torch.infer import (AutoencoderInference, export_impulse_response,
                              export_model, load_params)
from ddsp_torch.train import Trainer, train, train_loop
from ddsp_torch.utils import build_model, save_spec

torch.set_num_threads(1)

N_SAMPLES, N_FRAMES, SR = 3200, 50, 16000
SECS = N_SAMPLES / SR
KWARGS = dict(n_samples=N_SAMPLES, time_steps=N_FRAMES, reverb_length=800,
              use_angular_cumsum=True, compute_dtype='float32')
BATCH, STEPS = 2, 4


def _spy_on_prefetch(monkeypatch):
  """The prefetch iterators that train() makes, kept for inspection."""
  made = []

  def spy(*args, **kwargs):
    made.append(prefetch.prefetch_to_device(*args, **kwargs))
    return made[-1]

  monkeypatch.setattr(train_loop, 'prefetch_to_device', spy)
  return made


@pytest.fixture(scope='module')
def records(tmp_path_factory):
  """Two shards of centred 0.2 s examples (51 frames for 50 time steps)."""
  d = tmp_path_factory.mktemp('records')
  provider = SyntheticSinusoidProvider(n_samples=N_SAMPLES, n_examples=10,
                                       f0_range=(100.0, 200.0), seed=1)
  examples = list(provider.get_dataset(shuffle=False))
  rng = np.random.RandomState(2)
  for ex in examples:  # a noise floor in every spectrogram bin
    ex['audio'] = ex['audio'] + np.float32(0.02) * rng.randn(
        N_SAMPLES).astype(np.float32)
  write_examples(str(d / 'train.tfrecord-00000-of-00002'), examples[:5])
  write_examples(str(d / 'train.tfrecord-00001-of-00002'), examples[5:])
  return str(d / 'train.tfrecord*')


def _batches(records):
  return TFRecordProvider(records, example_secs=SECS, seed=0).get_batch(
      BATCH, shuffle=True)


def _train(records, prefetch_depth, save_dir=None, **kwargs):
  """Losses of each step of tiny trained from the records."""
  trainer = Trainer(build_model('tiny', device='cpu', seed=0, **KWARGS),
                    device='cpu', seed=0)
  losses = []
  step = trainer.train_step

  def recording_step(state, batch):
    state, out = step(state, batch)
    losses.append(out['total_loss'].item())
    return state, out

  trainer.train_step = recording_step
  train(_batches(records), trainer, num_steps=STEPS, steps_per_summary=2,
        save_dir=save_dir, prefetch=prefetch_depth, **kwargs)
  return losses


@pytest.fixture(scope='module')
def train_dir(records, tmp_path_factory):
  """A port train directory: save_spec, then train() with prefetch."""
  d = str(tmp_path_factory.mktemp('train'))
  save_spec(d, 'tiny', **KWARGS)
  losses = _train(records, 2, save_dir=d)
  return d, losses


# ---------------------------------------------------------------------------
# Prefetch
# ---------------------------------------------------------------------------
def test_prefetch_keeps_order_and_types():
  rng = np.random.RandomState(0)
  source = [{'audio': rng.randn(2, 5), 'midi': np.arange(2) + i,
             'f0_hz': rng.rand(2, 3).astype(np.float32)} for i in range(7)]
  source.append(({'x': np.ones(2)}, {'x': torch.zeros(2, dtype=torch.float64)}))
  threads = threading.active_count()
  got = list(prefetch.prefetch_to_device(iter(source), size=2, device='cpu'))
  assert threading.active_count() == threads  # no producer thread
  assert len(got) == len(source)
  for batch, ref in zip(got[:-1], source[:-1]):
    assert batch['audio'].dtype == torch.float32  # as jax.device_put
    assert batch['midi'].dtype == torch.int64
    for k, v in ref.items():
      np.testing.assert_array_equal(batch[k].numpy(),
                                    np.asarray(v, batch[k].numpy().dtype))
  assert isinstance(got[-1], tuple) and got[-1][1]['x'].dtype == torch.float32


def test_prefetch_bounds_its_queue():
  pulled = []

  def source():
    for i in range(50):
      pulled.append(i)
      yield {'x': np.full(3, i, np.float32)}

  it = prefetch.prefetch_to_device(source(), size=2, device='cpu')
  assert next(it)['x'][0].item() == 0
  # The batch handed over and the one read ahead of it, no more.
  assert pulled == [0, 1]
  assert next(it)['x'][0].item() == 1 and pulled == [0, 1, 2]
  rest = [b['x'][0].item() for b in it]
  assert rest == list(range(2, 50))


def test_prefetch_reraises_the_producers_exception():
  """The source's exception comes after every batch read before it."""
  def bad():
    for i in range(3):
      yield {'x': np.full(3, i, np.float32)}
    raise RuntimeError('boom')

  it = prefetch.prefetch_to_device(bad(), size=2, device='cpu')
  assert [next(it)['x'][0].item() for _ in range(3)] == [0, 1, 2]
  with pytest.raises(RuntimeError, match='boom'):
    next(it)


def test_prefetch_thread_ends_on_close():
  """No thread is left, and close() releases the batches in flight."""
  sent = []

  def endless():
    while True:
      x = torch.zeros(3)
      sent.append(weakref.ref(x))
      yield {'x': x}

  threads = threading.active_count()
  it = prefetch.prefetch_to_device(endless(), size=3, device='cpu')
  next(it)
  assert len(sent) == 3 and threading.active_count() == threads
  it.close()
  gc.collect()
  assert all(ref() is None for ref in sent)


def test_prefetch_runs_on_cuda_by_default(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    next(prefetch.prefetch_to_device(iter([{'x': np.zeros(1)}])))


def test_to_device_keeps_a_tensor_already_there():
  trainer = Trainer(build_model('tiny', device='cpu', seed=0, **KWARGS),
                    device='cpu')
  x = torch.zeros(2, 3)
  out = trainer.to_device({'x': x, 'y': np.zeros(2)})
  assert out['x'] is x and out['y'].dtype == torch.float32


# ---------------------------------------------------------------------------
# train() from TFRecords, with and without prefetch
# ---------------------------------------------------------------------------
def test_train_with_prefetch_matches_without(records, train_dir):
  _, prefetched = train_dir
  assert len(prefetched) == STEPS and np.all(np.isfinite(prefetched))
  assert _train(records, 0) == prefetched  # bit for bit


def test_the_producer_ends_on_early_stop_and_on_exception(records,
                                                          monkeypatch):
  """train() closes its prefetch (a closed generator has no frame) when it
  ends, when it stops early and when a step raises."""
  made = _spy_on_prefetch(monkeypatch)
  assert len(_train(records, 2)) == STEPS and made[0].gi_frame is None
  losses = _train(records, 2, early_stop_loss_value=1e9)
  assert len(losses) == 2 and len(made) == 2 and made[1].gi_frame is None

  trainer = Trainer(build_model('tiny', device='cpu', seed=0, **KWARGS),
                    device='cpu', seed=0)
  step = trainer.train_step
  calls = []

  def failing_step(state, batch):
    calls.append(1)
    if len(calls) == 2:
      raise ValueError('step failed')
    return step(state, batch)

  trainer.train_step = failing_step
  with pytest.raises(ValueError, match='step failed'):
    train(_batches(records), trainer, num_steps=STEPS, prefetch=2)
  assert len(made) == 3 and made[2].gi_frame is None


def test_a_step_from_centred_records_matches_jax(records):
  """Loudness from the audio, as solo_instrument trains; the port's
  parameters (seed 0, an audible noise floor) go to the JAX model."""
  batch = next(_batches(records))
  assert batch['f0_hz'].shape == (BATCH, N_FRAMES + 1)
  model_t = build_model('tiny', device='cpu', seed=0, **KWARGS)
  with torch.no_grad():
    model_t.decoder.dense_out.bias[-33:] = 4.0
  params = j_unflatten({k.replace('.', '/'): v.detach().numpy()
                        for k, v in model_t.named_parameters()})
  model_j = j_presets.tiny(**KWARGS)
  apply_j = jax.jit(lambda p, f: model_j.apply(
      {'params': p}, f, training=True, return_losses=True))
  outputs_j, losses_j = apply_j(
      params, {k: jnp.asarray(v) for k, v in batch.items()})
  noise = np.array(jax.random.uniform(jax.random.PRNGKey(0),
                                      (BATCH, N_SAMPLES), minval=-1.0,
                                      maxval=1.0))

  trainer = Trainer(model_t, device='cpu')
  with torch.no_grad():
    outputs_t, losses_t = model_t(trainer.to_device(batch), training=True,
                                  return_losses=True,
                                  noise=torch.from_numpy(noise))
  for key in ('f0_hz', 'loudness_db'):
    assert outputs_t[key].shape == (BATCH, N_FRAMES, 1)
    np.testing.assert_allclose(outputs_t[key].numpy(),
                               np.asarray(outputs_j[key]), rtol=1e-5,
                               atol=1e-4)
  np.testing.assert_allclose(losses_t['total_loss'].item(),
                             float(losses_j['total_loss']), rtol=1e-5)


# ---------------------------------------------------------------------------
# Export and serving
# ---------------------------------------------------------------------------
def test_save_spec_writes_the_jax_json(tmp_path):
  path = save_spec(str(tmp_path / 'port'), 'tiny', **KWARGS)
  j_path = j_registry.save_spec(str(tmp_path / 'jax'), 'tiny', **KWARGS)
  with open(path) as a, open(j_path) as b:
    assert a.read() == b.read()


def _features(seed=0):
  rng = np.random.RandomState(seed)
  t = np.linspace(0, 1, N_FRAMES, dtype=np.float32)
  return {'f0_hz': (150.0 * 2.0**(0.3 * np.sin(6 * t))).astype(np.float32),
          'loudness_db': (-60 + 40 * rng.rand(N_FRAMES)).astype(np.float32)}


@pytest.mark.parametrize('remove_reverb', [True, False])
def test_export_serves_in_jax_and_in_the_port(train_dir, tmp_path,
                                              remove_reverb):
  save_dir, _ = train_dir
  export_dir = str(tmp_path / 'export')
  path = export_model(save_dir, export_dir, length_seconds=SECS,
                      remove_reverb=remove_reverb, device='cpu')
  with open(f'{export_dir}/operative_spec.json') as f:
    spec = json.load(f)
  assert spec['preset'] == 'tiny' and spec['kwargs'] == dict(
      KWARGS, compute_loudness_fresh=False, use_angular_cumsum=True,
      **({'reverb': False} if remove_reverb else {}))

  # The flax tree: JAX's unflatten of it is exactly the JAX model's params.
  with np.load(path) as npz:
    params = j_unflatten({k: npz[k] for k in npz.files})
  model_j = j_presets.tiny(**spec['kwargs'])
  feats = {k: jnp.asarray(v)[None, :, None] for k, v in _features().items()}
  fresh = jax.eval_shape(lambda: model_j.init(
      {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)},
      feats, training=False))['params']
  assert (jax.tree_util.tree_structure(fresh) ==
          jax.tree_util.tree_structure(params))
  assert ('processor_group' in params) == (not remove_reverb)
  out_j = jax.jit(lambda p, f: model_j.apply({'params': p}, f,
                                             training=False))(params, feats)

  served = AutoencoderInference(export_dir, length_seconds=SECS,
                                remove_reverb=remove_reverb, device='cpu')
  noise = torch.from_numpy(np.array(jax.random.uniform(
      jax.random.PRNGKey(0), (1, N_SAMPLES), minval=-1.0, maxval=1.0)))
  audio = served(_features(), noise=noise)['audio_synth']
  np.testing.assert_allclose(audio.numpy(), np.asarray(out_j['audio_synth']),
                             atol=4e-3, rtol=0)

  from_train_dir = AutoencoderInference(save_dir, length_seconds=SECS,
                                        remove_reverb=remove_reverb,
                                        device='cpu')
  torch.testing.assert_close(from_train_dir(_features(), noise=noise)
                             ['audio_synth'], audio, rtol=0, atol=0)


def test_export_holds_only_the_parameters(train_dir, tmp_path):
  save_dir, _ = train_dir
  export_model(save_dir, str(tmp_path), length_seconds=SECS,
               remove_reverb=False, device='cpu')
  exported = load_params(str(tmp_path))
  trained = load_params(save_dir)  # the newest checkpoint
  model = build_model('tiny', device='cpu', **KWARGS)
  assert sorted(exported) == sorted(trained) == sorted(
      k.replace('.', '/') for k, _ in model.named_parameters())
  for k in exported:
    np.testing.assert_array_equal(exported[k], trained[k])


def test_impulse_response_wav(train_dir, tmp_path):
  save_dir, _ = train_dir
  path = export_impulse_response(save_dir, str(tmp_path / 'port'),
                                 target_sr=8000, device='cpu')
  ir = load_params(save_dir)['processor_group/reverb/ir']
  j_write_wav(str(tmp_path / 'jax' / 'ir.wav'), ir, SR)
  with open(path, 'rb') as a, open(tmp_path / 'jax' / 'ir.wav', 'rb') as b:
    assert a.read() == b.read()
  write_wav(str(tmp_path / 'again' / 'ir.wav'), ir, SR)
  with open(path, 'rb') as a, open(tmp_path / 'again' / 'ir.wav', 'rb') as b:
    assert a.read() == b.read()
  with wave.open(str(tmp_path / 'port' / 'reverb_ir_8000_hz.wav')) as w:
    assert (w.getframerate(), w.getnframes()) == (8000, 400)


def test_unported_formats_raise(train_dir, tmp_path):
  """The JAX package's converted formats raise and name the format the port
  writes (the 'tfjs' message once named 'savedmodel', which the port
  refuses too)."""
  save_dir, _ = train_dir
  for fmt in ('stablehlo', 'savedmodel', 'tflite', 'tfjs'):
    with pytest.raises(NotImplementedError, match="fmt='torch_export'"):
      export_model(save_dir, str(tmp_path), fmt=fmt)
  with pytest.raises(NotImplementedError, match='tensorflowjs'):
    export_model(save_dir, str(tmp_path), fmt='tfjs')
  with pytest.raises(ValueError, match='Unknown export format'):
    export_model(save_dir, str(tmp_path), fmt='onnx')
  with pytest.raises(ValueError, match='autoencoder'):
    export_model(save_dir, str(tmp_path), inference_model='vst_synthesize')
  with pytest.raises(FileNotFoundError, match='ckpt'):
    load_params(str(tmp_path))


def test_params_export_refuses_a_vst_directory(tmp_path):
  """fmt='params' exports an autoencoder; a vst train directory is refused
  (the JAX export fails on one too) instead of written with the
  autoencoder's mutations."""
  save_spec(str(tmp_path / 'vst'), 'vst', rnn_channels=16)
  with pytest.raises(ValueError, match="fmt='torch_export'"):
    export_model(str(tmp_path / 'vst'), str(tmp_path / 'out'), device='cpu')
  assert not (tmp_path / 'out').exists()
