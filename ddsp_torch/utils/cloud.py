"""Cloud helpers: GCS file staging and hypertune metric reporting.

Port of ddsp_tpu/utils/cloud.py (the standard library only). GCS access
uses the google-cloud-storage package where it imports, else shells out to
gsutil; hypertune reporting uses the hypertune package where it imports,
else appends the JSON line the AI-Platform hypertune service reads.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import tempfile
import time
from typing import List, Union

logger = logging.getLogger('ddsp_torch')


def download_from_gstorage(gstorage_path: str, local_path: str) -> str:
  """Download a gs:// object to a local path.

  The 'gs://' prefix is removed as a prefix (the reference's strip('gs:/')
  strips those characters from both ends, and so corrupts names that start
  or end in them).
  """
  if gstorage_path.startswith('gs://'):
    gstorage_path = gstorage_path[len('gs://'):]
  bucket_name, _, blob_path = gstorage_path.partition('/')
  try:
    from google.cloud import storage  # pylint: disable=g-import-not-at-top
    client = storage.Client()
    bucket = client.get_bucket(bucket_name)
    blob = bucket.blob(blob_path)
    blob.download_to_filename(local_path)
  except ImportError:
    subprocess.run(['gsutil', 'cp', f'gs://{gstorage_path}', local_path],
                   check=True)
  logger.info('Downloaded gs://%s to %s', gstorage_path, local_path)
  return local_path


def make_file_paths_local(paths: Union[str, List[str]],
                          local_dir: str) -> Union[str, List[str]]:
  """Stage gs:// paths into local_dir; local paths pass through."""
  single = isinstance(paths, str)
  paths_list = [paths] if single else list(paths)
  os.makedirs(local_dir, exist_ok=True)
  out = []
  for path in paths_list:
    if path.startswith('gs://'):
      local_path = os.path.join(local_dir, os.path.basename(path))
      download_from_gstorage(path, local_path)
      out.append(local_path)
    else:
      out.append(path)
  return out[0] if single else out


def report_metric_to_hypertune(metric_value: float, step: int,
                               tag: str = 'train_loss'):
  """Report a metric for AI-Platform hyperparameter tuning.

  Uses the hypertune package where it imports; otherwise appends to the
  file the service tails: $CLOUD_ML_HP_METRIC_FILE, by default
  hypertune/output.metrics in the temporary directory (/tmp on the
  service's machines).
  """
  try:
    import hypertune  # pylint: disable=g-import-not-at-top
    hpt = hypertune.HyperTune()
    hpt.report_hyperparameter_tuning_metric(
        hyperparameter_metric_tag=tag,
        metric_value=metric_value,
        global_step=step)
  except ImportError:
    path = os.environ.get(
        'CLOUD_ML_HP_METRIC_FILE',
        os.path.join(tempfile.gettempdir(), 'hypertune', 'output.metrics'))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'a') as f:
      f.write(json.dumps({'timestamp': time.time(), 'trial': os.environ.get(
          'CLOUD_ML_TRIAL_ID', '0'), tag: float(metric_value),
                          'global_step': int(step)}) + '\n')
