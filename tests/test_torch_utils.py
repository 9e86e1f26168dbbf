"""The port's notebook, cloud, test and plotting helpers against the JAX
package's, on the CPU; the packages that import no JAX; train()'s
hypertune flag.

The helpers are numpy, scipy's wavfile, subprocess and matplotlib in both
packages: the same inputs give the same bytes and arrays, except
`specplot`, whose magnitudes come from torch.fft in the port and jnp.fft in
the JAX package (SPEC_ATOL). `cloud` never reaches the network here:
subprocess.run, google.cloud and hypertune are stood in for.
"""

import itertools
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from ddsp_tpu.eval import plotting as j_plotting
from ddsp_tpu.utils import cloud as j_cloud
from ddsp_tpu.utils import notebook as j_notebook
from ddsp_tpu.utils import test_util as j_test_util
from ddsp_torch.eval import plotting
from ddsp_torch.utils import cloud, notebook, test_util

torch.set_num_threads(1)

# specplot draws log10 of |STFT| clamped at 1e-6: the two frameworks'
# float32 FFTs of the same frames agree to a few ulps of each bin, which
# log10 leaves at ~1e-6 (7.7e-6 measured on an x86 CPU; the quietest bin
# here is 10^-2.2, far above the clamp).
SPEC_ATOL = 1e-4


@pytest.mark.parametrize('args', [(440.0, 0.5, 16000, 0.25),
                                  (261.6, 1.0, 22050, 0.1)])
def test_test_util_matches_jax_bit_for_bit(args):
  np.testing.assert_array_equal(test_util.gen_np_sinusoid(*args),
                                j_test_util.gen_np_sinusoid(*args))
  np.testing.assert_array_equal(
      test_util.gen_np_batched_sinusoids(*args, batch_size=3),
      j_test_util.gen_np_batched_sinusoids(*args, batch_size=3))


def _audio(n=4000, seed=0):
  rng = np.random.RandomState(seed)
  return (0.8 * np.sin(np.arange(n) * 0.05) + 0.3 * rng.randn(n)).astype(
      np.float32)


def test_notebook_wav_bytes_and_reading_match_jax():
  audio = _audio()
  for x, rate in ((audio, 16000), (audio[None], 16000), (2 * audio, 8000)):
    want = j_notebook.audio_to_wav_bytes(x, rate)
    assert notebook.audio_to_wav_bytes(x, rate) == want
    for kwargs in ({}, {'sample_rate': 22050}, {'normalize_db': 0.5}):
      np.testing.assert_array_equal(
          notebook.audio_bytes_to_np(want, **kwargs),
          j_notebook.audio_bytes_to_np(want, **kwargs))
  for db in (None, 0.1, -3.0):
    np.testing.assert_array_equal(notebook.normalize_audio(audio, db),
                                  j_notebook.normalize_audio(audio, db))


def test_notebook_play_record_and_upload(tmp_path, monkeypatch, capsys):
  audio = _audio()
  path = notebook.play(audio, out_path=str(tmp_path / 'a.wav'))
  assert path == str(tmp_path / 'a.wav')
  assert pathlib.Path(path).read_bytes() == j_notebook.audio_to_wav_bytes(
      audio)
  monkeypatch.setattr('tempfile.tempdir', str(tmp_path))
  path = notebook.play(audio[None])
  assert pathlib.Path(path).parent == tmp_path
  assert path in capsys.readouterr().out
  with pytest.raises(RuntimeError, match='frontend'):
    notebook.record()
  monkeypatch.setitem(sys.modules, 'google.colab', None)
  for package in (notebook, j_notebook):
    with pytest.raises(RuntimeError, match='frontend'):
      package.upload()


def _stage(package, monkeypatch, tmp_path):
  """Runs make_file_paths_local through gsutil (google.cloud stood in by an
  import failure, subprocess.run recorded); returns (result, argv list)."""
  calls = []
  monkeypatch.setitem(sys.modules, 'google.cloud', None)
  monkeypatch.setattr(subprocess, 'run',
                      lambda argv, check: calls.append((argv, check)))
  out = package.make_file_paths_local(
      ['gs://gs-bucket/dir/model.gin', 'local/x.gin'], str(tmp_path))
  single = package.make_file_paths_local('gs://b/s.gin', str(tmp_path))
  return (out, single), calls


def test_cloud_staging_through_gsutil_matches_jax(monkeypatch, tmp_path):
  (paths, single), calls = _stage(cloud, monkeypatch, tmp_path)
  want, want_calls = _stage(j_cloud, monkeypatch, tmp_path)
  assert (paths, single) == want
  assert calls == want_calls == [
      (['gsutil', 'cp', 'gs://gs-bucket/dir/model.gin',
        str(tmp_path / 'model.gin')], True),
      (['gsutil', 'cp', 'gs://b/s.gin', str(tmp_path / 's.gin')], True)]
  assert paths == [str(tmp_path / 'model.gin'), 'local/x.gin']
  assert single == str(tmp_path / 's.gin')


def test_cloud_download_through_the_storage_client(monkeypatch, tmp_path):
  seen = []

  class Blob:

    def __init__(self, name):
      self.name = name

    def download_to_filename(self, path):
      seen.append((self.name, path))

  class Bucket:

    def __init__(self, name):
      self.name = name

    def blob(self, path):
      return Blob(f'{self.name}:{path}')

  storage = types.SimpleNamespace(Client=lambda: types.SimpleNamespace(
      get_bucket=Bucket))
  google_cloud = types.ModuleType('google.cloud')
  google_cloud.storage = storage
  monkeypatch.setitem(sys.modules, 'google.cloud', google_cloud)
  monkeypatch.setattr(subprocess, 'run', None)  # must not be reached
  local = str(tmp_path / 'w.npz')
  for package in (cloud, j_cloud):
    assert package.download_from_gstorage('gs://staging-gs/ckpt/w.npz',
                                          local) == local
  assert seen == [('staging-gs:ckpt/w.npz', local)] * 2


def test_cloud_hypertune_report_matches_jax(monkeypatch, tmp_path):
  monkeypatch.setitem(sys.modules, 'hypertune', None)
  monkeypatch.setenv('CLOUD_ML_TRIAL_ID', '7')
  lines = {}
  for name, package in (('port', cloud), ('jax', j_cloud)):
    path = tmp_path / name / 'output.metrics'
    monkeypatch.setenv('CLOUD_ML_HP_METRIC_FILE', str(path))
    package.report_metric_to_hypertune(1.25, 10)
    package.report_metric_to_hypertune(np.float32(0.5), 20, tag='eval_loss')
    lines[name] = [json.loads(x) for x in path.read_text().splitlines()]
  for line in itertools.chain(*lines.values()):
    assert isinstance(line.pop('timestamp'), float)
  assert lines['port'] == lines['jax'] == [
      {'trial': '7', 'train_loss': 1.25, 'global_step': 10},
      {'trial': '7', 'eval_loss': 0.5, 'global_step': 20}]

  reports = []
  hpt = types.SimpleNamespace(
      report_hyperparameter_tuning_metric=lambda **kw: reports.append(kw))
  monkeypatch.setitem(sys.modules, 'hypertune', types.SimpleNamespace(
      HyperTune=lambda: hpt))
  cloud.report_metric_to_hypertune(2.0, 3)
  assert reports == [{'hyperparameter_metric_tag': 'train_loss',
                      'metric_value': 2.0, 'global_step': 3}]


@pytest.mark.parametrize('rotate', [True, False])
def test_specplot_matches_jax(rotate):
  import matplotlib.pyplot as plt
  audio = _audio(8000)
  ax = plotting.specplot(audio, rotate=rotate, device='cpu')
  want_ax = j_plotting.specplot(audio, rotate=rotate)
  got = np.asarray(ax.images[0].get_array())
  want = np.asarray(want_ax.images[0].get_array())
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=SPEC_ATOL)
  assert ax.get_xlabel() == want_ax.get_xlabel() == 'Time'
  plt.close('all')


def test_specplot_takes_the_card_by_default(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    plotting.specplot(_audio(4000))


def test_transfer_function_and_figures_match_jax():
  import matplotlib.pyplot as plt
  rng = np.random.RandomState(3)
  ir = rng.randn(2, 300).astype(np.float32)
  for got, want in zip(plotting.transfer_function(ir, 22050),
                       j_plotting.transfer_function(ir, 22050)):
    np.testing.assert_array_equal(got, want)
  desired = np.abs(rng.randn(65))
  fig = plotting.plot_impulse_responses(ir[0], desired)
  want_fig = j_plotting.plot_impulse_responses(ir[0], desired)
  assert len(fig.axes) == len(want_fig.axes) == 2
  for ax, want_ax in zip(fig.axes, want_fig.axes):
    assert ax.get_title() == want_ax.get_title()
    for line, want_line in zip(ax.get_lines(), want_ax.get_lines()):
      np.testing.assert_array_equal(line.get_xydata(),
                                    want_line.get_xydata())
  fig, ax, sp_ax = plotting.pianoroll_plot_setup(figsize=(4, 3),
                                                 xlim=(0, 10))
  want = j_plotting.pianoroll_plot_setup(figsize=(4, 3), xlim=(0, 10))
  assert len(sp_ax.patches) == len(want[2].patches) == 120
  assert len(ax.patches) == len(want[1].patches)
  assert ax.get_xlim() == want[1].get_xlim() == (0.0, 10.0)
  plt.close('all')


def test_port_packages_import_no_jax():
  code = ('import sys, ddsp_torch.parallel, ddsp_torch.train, '
          'ddsp_torch.eval, ddsp_torch.utils; '
          "bad = [m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'flax', 'ddsp_tpu', 'optax')]; "
          "print(bad, 'matplotlib' in sys.modules)")
  out = subprocess.run([sys.executable, '-c', code], check=True,
                       capture_output=True, text=True,
                       cwd=str(pathlib.Path(__file__).resolve().parents[1]))
  assert out.stdout.strip() == '[] False'


def test_train_takes_report_loss_to_hypertune():
  from ddsp_torch.train import Trainer, train
  from ddsp_torch.utils import build_model
  rng = np.random.RandomState(2)
  batch = {'audio': (0.1 * rng.randn(2, 16000)).astype(np.float32),
           'f0_hz': np.full((2, 250, 1), 220.0, np.float32)}
  params = []
  for flag in (False, True):
    trainer = Trainer(build_model('tiny', device='cpu', seed=0),
                      device='cpu')
    state = train(itertools.repeat(batch), trainer, num_steps=1,
                  steps_per_summary=1, report_loss_to_hypertune=flag,
                  prefetch=0)
    assert state.step == 1
    params.append({k: v.detach().clone() for k, v in state.params.items()})
  for k, v in params[0].items():
    assert torch.equal(v, params[1][k]), k


def test_list_presets_matches_jax():
  """The port registers the JAX package's presets, by the same names."""
  from ddsp_tpu.utils import list_presets as j_list_presets  # pylint: disable=g-import-not-at-top
  from ddsp_torch.utils import list_presets
  assert list_presets() == j_list_presets()


# (n_freqs, window_size): no window, windows past the IR's 2 * (n_freqs - 1)
# samples, and cropping windows of both parities.
IR_GRID = [(n, w) for n in (2, 3, 9, 65, 257)
           for w in (-1, 0, 1, 2, 3, 4, 7, 8, 63, 64, 127, 128, 512, 600)]


def test_designed_ir_size_matches_jax_and_the_crop():
  """designed_ir_size against the JAX function on the grid, and the length
  of the IR that frequency_impulse_response makes there against the JAX
  function's and designed_ir_size. A cropping window of one or two samples
  keeps two in both packages, where designed_ir_size says one."""
  # pylint: disable=g-import-not-at-top
  from ddsp_tpu.ops import fftconv as j_fftconv
  from ddsp_torch.ops import fftconv
  for n_freqs, window_size in IR_GRID:
    want = j_fftconv.designed_ir_size(n_freqs, window_size)
    assert fftconv.designed_ir_size(n_freqs, window_size) == want
    ir = fftconv.frequency_impulse_response(torch.ones(1, 2, n_freqs),
                                            window_size=window_size)
    j_ir = j_fftconv.frequency_impulse_response(np.ones((1, 2, n_freqs)),
                                                window_size=window_size)
    assert ir.shape == j_ir.shape, (n_freqs, window_size)
    crops_to_one = 0 < window_size <= 2 and window_size < 2 * (n_freqs - 1)
    assert ir.shape[-1] == (2 if crops_to_one else want), (n_freqs,
                                                           window_size)
