"""Network modules (port of ddsp_tpu.nn)."""

from ddsp_torch.nn.decoders import RnnFcDecoder
from ddsp_torch.nn.encoders import (AggregateFeaturesEncoder,
                                    ExpressionEncoder, HarmonicToMidiEncoder,
                                    MfccEncoder, MfccRnnEncoder,
                                    MfccTimeDistributedRnnEncoder,
                                    MidiEncoder, OneHotEncoder,
                                    ResnetSinusoidalEncoder,
                                    SinusoidalToHarmonicEncoder, ZEncoder)
from ddsp_torch.nn.layers import (Dense, DictModule, Embedding, FastGRU, Fc,
                                  FcStack, FcStackOut, GRUCell, Identity,
                                  LayerNorm, Normalize, OptimizedLSTMCell,
                                  Rnn, RnnFc, RnnSandwich, SingleGru,
                                  StatelessRnn, ensure_4d, get_nonlinearity,
                                  inv_ensure_4d, normalize_op, split_to_dict)
from ddsp_torch.nn.preprocessing import (F0LoudnessPreprocessor,
                                         F0PowerPreprocessor,
                                         OnlineF0PowerPreprocessor)
from ddsp_torch.nn.resnet import (ConditionalNorm, ConditionalScaleAndShift,
                                  NormReluConv, ResidualLayer, ResidualStack,
                                  ResNet)

__all__ = ['RnnFcDecoder', 'AggregateFeaturesEncoder', 'ExpressionEncoder',
           'HarmonicToMidiEncoder', 'MfccEncoder', 'MfccRnnEncoder',
           'MfccTimeDistributedRnnEncoder', 'MidiEncoder', 'OneHotEncoder',
           'ResnetSinusoidalEncoder', 'SinusoidalToHarmonicEncoder',
           'ZEncoder', 'Dense', 'DictModule', 'Embedding', 'FastGRU', 'Fc',
           'FcStack', 'FcStackOut', 'GRUCell', 'Identity', 'LayerNorm',
           'Normalize', 'OptimizedLSTMCell', 'Rnn', 'RnnFc', 'RnnSandwich',
           'SingleGru', 'StatelessRnn', 'ensure_4d', 'get_nonlinearity',
           'inv_ensure_4d', 'normalize_op', 'split_to_dict',
           'F0LoudnessPreprocessor', 'F0PowerPreprocessor',
           'OnlineF0PowerPreprocessor', 'ConditionalNorm',
           'ConditionalScaleAndShift', 'NormReluConv', 'ResidualLayer',
           'ResidualStack', 'ResNet']
