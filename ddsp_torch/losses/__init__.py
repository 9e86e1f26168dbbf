"""Losses (port of ddsp_tpu.losses): multi-scale spectral and parameter."""

from ddsp_torch.losses.spectral import (Loss, LossGroup, ParamLoss,
                                        SpectralLoss, mean_difference)

__all__ = ['Loss', 'LossGroup', 'ParamLoss', 'SpectralLoss',
           'mean_difference']
