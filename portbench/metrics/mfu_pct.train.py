"""The step's products (forward once, backward twice, from the
configuration's shapes) times the steps of the timed window, over the
window and the published dense peak of the configuration's compute dtype
on one H100."""

from portbench.harness import roofline


def read(record):
  steps, seconds = record.get('window_steps'), record.get('window_s')
  if not steps or not seconds:
    return None
  peak = roofline.PEAK_FLOPS[record['config']['peak_dtype']]
  return 100.0 * record['step_flops'] * steps / (seconds * peak)
