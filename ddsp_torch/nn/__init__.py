"""Network modules (port of ddsp_tpu.nn)."""

from ddsp_torch.nn.decoders import RnnFcDecoder
from ddsp_torch.nn.layers import (Dense, DictModule, FastGRU, Fc, FcStack,
                                  LayerNorm, Rnn, get_nonlinearity,
                                  split_to_dict)
from ddsp_torch.nn.preprocessing import F0LoudnessPreprocessor

__all__ = ['RnnFcDecoder', 'Dense', 'DictModule', 'FastGRU', 'Fc', 'FcStack',
           'LayerNorm', 'Rnn', 'get_nonlinearity', 'split_to_dict',
           'F0LoudnessPreprocessor']
