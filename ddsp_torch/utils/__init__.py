"""Registry, spec reader, parameter conversion and device selection."""

from ddsp_torch.utils.convert import load_jax_params
from ddsp_torch.utils.device import resolve_device
from ddsp_torch.utils.registry import (SPEC_FILENAME, build_model,
                                       get_preset, init_parameters,
                                       load_spec, model_from_spec,
                                       register_preset)

__all__ = ['load_jax_params', 'resolve_device', 'SPEC_FILENAME',
           'build_model', 'get_preset', 'init_parameters', 'load_spec',
           'model_from_spec', 'register_preset']
