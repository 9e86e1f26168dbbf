"""Processors, processor groups and DAGs (port of ddsp_tpu.proc)."""

from ddsp_torch.proc.dags import (DAGModule, default_module_name, is_loss,
                                  is_processor)
from ddsp_torch.proc.effects import (ExpDecayReverb, FilteredNoiseReverb,
                                     FIRFilter, ModDelay, Reverb)
from ddsp_torch.proc.processors import (Add, Crop, Mix, Processor,
                                        ProcessorGroup)
from ddsp_torch.proc.synths import (FilteredNoise, Harmonic, Sinusoidal,
                                    TensorToAudio, Wavetable)

__all__ = ['DAGModule', 'default_module_name', 'is_loss', 'is_processor',
           'ExpDecayReverb', 'FilteredNoiseReverb', 'FIRFilter',
           'ModDelay', 'Reverb', 'Add', 'Crop', 'Mix', 'Processor',
           'ProcessorGroup', 'FilteredNoise', 'Harmonic', 'Sinusoidal',
           'TensorToAudio', 'Wavetable']
