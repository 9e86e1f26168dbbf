"""Share of the timed window in which no operation ran on the device, over
rendering requests: 1 - (device-busy seconds per second of audio, from
torch.profiler's timeline of one traced block of the mix) x (seconds of
audio per second of the untraced timed window). The profiler slows the
host's dispatch, so the traced window's own idle share overstates the
timed window's; its busy time does not."""


def read(record):
  tr = record.get('trace')
  if tr is None or not tr.device or not record.get('window_audio_s'):
    return None
  busy = tr.busy_s() / record['traced_audio_s']
  return 100.0 * (1.0 - busy * record['window_audio_s'] / record['window_s'])
