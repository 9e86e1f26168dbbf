"""Losses (port of ddsp_tpu.losses): multi-scale spectral, parameter,
consistency, TWM, HMM and CREPE-embedding families."""

from ddsp_torch.losses.consistency import (FilteredNoiseConsistencyLoss,
                                           HarmonicConsistencyLoss,
                                           KDEConsistencyLoss,
                                           WassersteinConsistencyLoss,
                                           amp_loss, freq_loss,
                                           mixture_log_prob, normal_log_prob,
                                           wasserstein_distance)
from ddsp_torch.losses.crepe_embedding import (EmbeddingLoss,
                                               PretrainedCREPEEmbeddingLoss)
from ddsp_torch.losses.hmm_transcriber import HmmTranscriber
from ddsp_torch.losses.spectral import (Loss, LossGroup, ParamLoss,
                                        SpectralLoss, mean_difference)
from ddsp_torch.losses.twm import TWMLoss

__all__ = ['EmbeddingLoss', 'FilteredNoiseConsistencyLoss',
           'HarmonicConsistencyLoss', 'HmmTranscriber', 'KDEConsistencyLoss',
           'Loss', 'LossGroup', 'ParamLoss', 'PretrainedCREPEEmbeddingLoss',
           'SpectralLoss', 'TWMLoss', 'WassersteinConsistencyLoss',
           'amp_loss', 'freq_loss', 'mean_difference', 'mixture_log_prob',
           'normal_log_prob', 'wasserstein_distance']
