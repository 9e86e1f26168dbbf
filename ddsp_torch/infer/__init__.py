"""Inference wrappers (port of ddsp_tpu.infer)."""

from ddsp_torch.infer.inference import (AutoencoderInference,
                                        VSTExtractFeatures,
                                        VSTPredictControls,
                                        VSTStatelessPredictControls,
                                        VSTSynthesize, VSTSynthesizeHarmonic,
                                        VSTSynthesizeNoise, load_params)

__all__ = ['AutoencoderInference', 'VSTExtractFeatures', 'VSTPredictControls',
           'VSTStatelessPredictControls', 'VSTSynthesize',
           'VSTSynthesizeHarmonic', 'VSTSynthesizeNoise', 'load_params']
