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
                                  OutputSplitsModule, Rnn, RnnFc,
                                  RnnSandwich, SingleGru, StatelessRnn,
                                  ensure_4d, get_nonlinearity, inv_ensure_4d,
                                  normalize_op, split_to_dict)
from ddsp_torch.nn.preprocessing import (F0LoudnessPreprocessor,
                                         F0PowerPreprocessor,
                                         OnlineF0PowerPreprocessor,
                                         inv_scale_db, inv_scale_f0_hz,
                                         scale_db, scale_f0_hz)
from ddsp_torch.nn.resnet import (ConditionalNorm, ConditionalScaleAndShift,
                                  NormReluConv, ResidualLayer, ResidualStack,
                                  ResNet, get_norm)
from ddsp_torch.nn.stops import (get_note_lengths, get_note_mask,
                                 get_note_mask_from_onset, get_note_moments,
                                 get_short_note_loss_mask, pool_over_notes,
                                 straight_through_choice,
                                 straight_through_int_quantization,
                                 straight_through_softmax)
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
           'ResidualStack', 'ResNet', 'OutputSplitsModule', 'get_norm',
           'scale_db', 'inv_scale_db', 'scale_f0_hz', 'inv_scale_f0_hz',
           'get_note_lengths', 'get_note_mask', 'get_note_mask_from_onset',
           'get_note_moments', 'get_short_note_loss_mask', 'pool_over_notes',
           'straight_through_choice', 'straight_through_int_quantization',
           'straight_through_softmax']
