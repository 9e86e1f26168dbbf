"""The decoder's products in the forward of every request finished in the
timed window (from the configuration's shapes and each clip's frames),
over the window and the published dense peak of the configuration's
compute dtype on one H100."""

from portbench.harness import roofline


def read(record):
  seconds = record.get('window_s')
  if not seconds or not record.get('window_flops'):
    return None
  peak = roofline.PEAK_FLOPS[record['config']['peak_dtype']]
  return 100.0 * record['window_flops'] / (seconds * peak)
