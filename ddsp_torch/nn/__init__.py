"""Network modules (port of ddsp_tpu.nn)."""

from ddsp_torch.nn.decoders import RnnFcDecoder
from ddsp_torch.nn.layers import (Dense, DictModule, FastGRU, Fc, FcStack,
                                  LayerNorm, Rnn, StatelessRnn,
                                  get_nonlinearity, split_to_dict)
from ddsp_torch.nn.preprocessing import (F0LoudnessPreprocessor,
                                         F0PowerPreprocessor,
                                         OnlineF0PowerPreprocessor)

__all__ = ['RnnFcDecoder', 'Dense', 'DictModule', 'FastGRU', 'Fc', 'FcStack',
           'LayerNorm', 'Rnn', 'StatelessRnn', 'get_nonlinearity',
           'split_to_dict', 'F0LoudnessPreprocessor', 'F0PowerPreprocessor',
           'OnlineF0PowerPreprocessor']
