"""Training: Trainer, train loop, checkpoints (port of ddsp_tpu.train)."""

from ddsp_torch.train.train_loop import MetricsWriter, train
from ddsp_torch.train.trainer import Trainer, TrainState

__all__ = ['MetricsWriter', 'train', 'Trainer', 'TrainState']
