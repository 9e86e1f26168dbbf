"""Evaluation helpers (port of ddsp_tpu.eval): so far summaries.write_wav."""
