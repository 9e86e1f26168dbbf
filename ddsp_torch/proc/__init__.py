"""Processors, processor groups and DAGs (port of ddsp_tpu.proc)."""

from ddsp_torch.proc.dags import DAGModule
from ddsp_torch.proc.effects import FilteredNoiseReverb, Reverb
from ddsp_torch.proc.processors import Add, Crop, Processor, ProcessorGroup
from ddsp_torch.proc.synths import FilteredNoise, Harmonic

__all__ = ['DAGModule', 'FilteredNoiseReverb', 'Reverb', 'Add', 'Crop',
           'Processor', 'ProcessorGroup', 'FilteredNoise', 'Harmonic']
