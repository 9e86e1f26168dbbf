"""Share of the timed window in which no operation ran on the device, in
training steps: 1 - (device-busy seconds per step, from torch.profiler's
timeline of the traced steps) / (seconds per step of the untraced timed
window). The profiler slows the host's dispatch, so the traced window's
own idle share overstates the timed window's; its busy time does not."""


def read(record):
  tr = record.get('trace')
  if tr is None or not tr.device or not record.get('window_steps'):
    return None
  busy = tr.busy_s() / record['steps']
  return 100.0 * (1.0 - busy / (record['window_s'] / record['window_steps']))
