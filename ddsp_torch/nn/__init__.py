"""Network modules (port of ddsp_tpu.nn)."""

from ddsp_torch.nn import stops
from ddsp_torch.nn.decoders import (DilatedConvDecoder, FcStackDecoder,
                                    MidiDecoder, MidiToHarmonicDecoder,
                                    RnnFcDecoder)
from ddsp_torch.nn.dilated_conv import (DilatedConvStack, PolyphaseResample,
                                        SpectralNorm, polyphase_resample)
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
from ddsp_torch.nn.vq import VectorQuantization

__all__ = ['stops', 'DilatedConvDecoder', 'FcStackDecoder', 'MidiDecoder',
           'MidiToHarmonicDecoder', 'RnnFcDecoder', 'DilatedConvStack',
           'PolyphaseResample', 'SpectralNorm', 'polyphase_resample',
           'VectorQuantization', 'AggregateFeaturesEncoder', 'ExpressionEncoder',
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
