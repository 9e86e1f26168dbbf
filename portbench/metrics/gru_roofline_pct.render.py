"""K2f's share of its roofline over rendering requests: the least time of
each traced request's recurrence (T = its frames, B = 1) over the device
time of the operations launched under ddsp_torch::gru_fwd."""

from portbench.harness import roofline


def read(record):
  tr = record.get('trace')
  if tr is None:
    return None
  cfg = record['cfg']
  calls, seconds = tr.op_device_s(['ddsp_torch::gru_fwd'])
  frames = record['traced_frames']
  if calls != len(frames):
    return None
  return roofline.share_pct(
      [roofline.k2_bound_s('fwd', t, 1, record['gru_hidden'],
                           cfg['compute_dtype']) for t in frames], seconds)
