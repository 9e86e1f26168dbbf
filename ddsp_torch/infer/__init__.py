"""Inference wrappers (port of ddsp_tpu.infer)."""

from ddsp_torch.infer.inference import AutoencoderInference, load_params

__all__ = ['AutoencoderInference', 'load_params']
