"""Inference wrappers and export (port of ddsp_tpu.infer)."""

from ddsp_torch.infer.export import (export_impulse_response, export_model,
                                     load_program, unflatten)
from ddsp_torch.infer.inference import (AutoencoderInference,
                                        VSTExtractFeatures,
                                        VSTPredictControls,
                                        VSTStatelessPredictControls,
                                        VSTSynthesize, VSTSynthesizeHarmonic,
                                        VSTSynthesizeNoise, load_params)

__all__ = ['AutoencoderInference', 'VSTExtractFeatures', 'VSTPredictControls',
           'VSTStatelessPredictControls', 'VSTSynthesize',
           'VSTSynthesizeHarmonic', 'VSTSynthesizeNoise',
           'export_impulse_response', 'export_model', 'load_params',
           'load_program', 'unflatten']
