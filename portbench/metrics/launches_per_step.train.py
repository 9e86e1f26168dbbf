"""Kernel launch calls (runtime and driver API) per training step in the
traced window."""


def read(record):
  tr = record.get('trace')
  if tr is None or not tr.launches:
    return None
  return tr.n_launches() / record['steps']
