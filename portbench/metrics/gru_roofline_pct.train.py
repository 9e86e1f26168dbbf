"""K2's share of its roofline in training steps: the least time of the
recurrence's work from its (T, B, H, dtype) for each ddsp_torch::gru_fwd call
(K2f) and each ddsp_torch::gru_bwd call (K2b's serial and weight-gradient
passes), over the device time of the operations launched under them."""

from portbench.harness import roofline


def read(record):
  tr = record.get('trace')
  if tr is None:
    return None
  shape = record['gru']
  least, device = [], 0.0
  for op, bound in (('ddsp_torch::gru_fwd',
                     lambda: roofline.k2_bound_s('fwd', *shape)),
                    ('ddsp_torch::gru_bwd',
                     lambda: roofline.k2_bwd_bound_s(*shape))):
    calls, seconds = tr.op_device_s([op])
    least += [bound()] * calls
    device += seconds
  return roofline.share_pct(least, device)
