"""K1's share of its roofline in training steps: the least time of the
harmonic synthesis's work from (B, samples, frames, harmonics) and the
audible harmonics of the steps' f0 for each ddsp_torch::harmonic_fwd call
(K1f) and ddsp_torch::harmonic_bwd_taps call (K1t), over the device time
of the operations launched under them."""

from portbench.harness import roofline


def read(record):
  tr = record.get('trace')
  if tr is None:
    return None
  cfg = record['cfg']
  active = [roofline.k1_active(f0, cfg['n_samples'], cfg['n_harmonics'],
                               cfg['sample_rate'])
            for f0 in record['f0_frames']]
  shape = (record['batch'], cfg['n_samples'], cfg['time_steps'],
           cfg['n_harmonics'])
  least, device = [], 0.0
  for op, kernel in (('ddsp_torch::harmonic_fwd', 'fwd'),
                     ('ddsp_torch::harmonic_bwd_taps', 'bwd_taps')):
    calls, seconds = tr.op_device_s([op])
    if calls != len(active):
      return None
    least += [roofline.k1_bound_s(kernel, *shape, a) for a in active]
    device += seconds
  return roofline.share_pct(least, device)
