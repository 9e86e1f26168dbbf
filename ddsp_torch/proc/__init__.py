"""Processors, processor groups and DAGs (port of ddsp_tpu.proc)."""

from ddsp_torch.proc.dags import DAGModule
from ddsp_torch.proc.effects import Reverb
from ddsp_torch.proc.processors import Add, Processor, ProcessorGroup
from ddsp_torch.proc.synths import FilteredNoise, Harmonic

__all__ = ['DAGModule', 'Reverb', 'Add', 'Processor', 'ProcessorGroup',
           'FilteredNoise', 'Harmonic']
