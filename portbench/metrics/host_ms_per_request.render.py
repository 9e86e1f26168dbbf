"""Host ms per request from the call into AutoencoderInference until it
returns the audio tensor, before the copy to the host waits for the
card: the enqueue that paces short clips (mean over the timed window)."""


def read(record):
  return record.get('host_ms')
