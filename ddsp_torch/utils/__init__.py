"""Registry, spec reader, parameter conversion, device selection, and the
notebook, cloud and test helpers."""

from ddsp_torch.utils import cloud  # noqa: F401
from ddsp_torch.utils import notebook  # noqa: F401
from ddsp_torch.utils import test_util  # noqa: F401
from ddsp_torch.utils.convert import load_jax_params
from ddsp_torch.utils.device import resolve_device
from ddsp_torch.utils.registry import (SPEC_FILENAME, build_model,
                                       get_preset, init_parameters,
                                       list_presets, load_spec,
                                       model_from_spec, register_preset,
                                       save_spec)

__all__ = ['cloud', 'notebook', 'test_util', 'load_jax_params',
           'resolve_device', 'SPEC_FILENAME', 'build_model', 'get_preset',
           'init_parameters', 'list_presets', 'load_spec',
           'model_from_spec', 'register_preset', 'save_spec']
