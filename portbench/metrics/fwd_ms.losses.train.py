"""Device ms per training step of the forward of the 'losses' layer: CUDA
events that forward pre-hooks and hooks record around its modules,
over untraced steps after the traced window (stream time: a gap inside the
forward counts)."""


def read(record):
  value = record.get('layer_ms', {}).get('losses')
  return value if value else None
