"""Data-driven DAGs of modules over nested dictionaries of tensors.

Port of ddsp_tpu/proc/dags.py. A DAG is a list of nodes
`(module, [input_key, ...][, [output_key, ...]])`: input keys are nested
'a/b/c' keys into the growing outputs dict (the DAG inputs are there both at
the top level and under 'inputs/'); each node's outputs land under the
module's name, and 'out' aliases the final node's.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Sequence, Tuple

from torch import nn

from ddsp_torch.ops.core import nested_lookup, to_dict

TensorDict = Dict[str, Any]
Node = Tuple[Any, ...]


def is_processor(v) -> bool:
  """Duck typing for processors (get_controls -> get_signal modules)."""
  return hasattr(v, 'get_signal') and hasattr(v, 'get_controls')


def is_loss(v) -> bool:
  """Duck typing for loss modules."""
  return hasattr(v, 'get_losses_dict')


def snake_case(name: str) -> str:
  s1 = re.sub('(.)([A-Z][a-z]+)', r'\1_\2', name)
  return re.sub('([a-z0-9])([A-Z])', r'\1_\2', s1).lower()


def default_module_name(module) -> str:
  """The module's explicit `name` if it has one, else its snake_case class."""
  name = getattr(module, 'name', None)
  return name if name else snake_case(type(module).__name__)


def loss_module_name(loss_obj) -> str:
  """Dict key for a loss module: its `name`, else its snake_case class."""
  return default_module_name(loss_obj)


class DAGModule(nn.Module):
  """Strings submodules together according to a dag spec.

  Each node's module is registered under its name, so its parameters are
  named '<name>.<param>' as in the JAX package's tree.
  """

  def __init__(self, dag: Sequence[Node]):
    super().__init__()
    self.node_names = []
    self.node_input_keys = []
    self.node_output_keys = []
    for node in dag:
      name = default_module_name(node[0])
      if name in self.node_names:
        raise ValueError(f'Duplicate module name in dag: {name!r}')
      self.add_module(name, node[0])
      self.node_names.append(name)
      self.node_input_keys.append(tuple(node[1]))
      self.node_output_keys.append(tuple(node[2]) if len(node) > 2 else None)

  def forward(self, inputs: TensorDict, **kwargs) -> TensorDict:
    return self.run_dag(inputs, **kwargs)

  def run_dag(self, inputs: TensorDict, **kwargs) -> TensorDict:
    """Run the dag; kwargs go to every processor node (e.g. noise=...).

    A dict `noise` is {node name: tensor}: each processor gets its own
    entry (None where there is none).
    """
    outputs = dict(inputs)
    outputs['inputs'] = inputs
    module_outputs = {}
    for name, in_keys, out_keys in zip(self.node_names, self.node_input_keys,
                                       self.node_output_keys):
      module = getattr(self, name)
      node_inputs = [nested_lookup(key, outputs) for key in in_keys]
      if is_processor(module):
        node_kwargs = dict(kwargs)
        if isinstance(node_kwargs.get('noise'), dict):
          node_kwargs['noise'] = node_kwargs['noise'].get(name)
        module_outputs = module(*node_inputs, return_outputs_dict=True,
                                **node_kwargs)
      elif is_loss(module):
        module_outputs = module.get_losses_dict(*node_inputs, **kwargs)
      else:
        module_outputs = module(*node_inputs)
      if not isinstance(module_outputs, dict):
        module_outputs = to_dict(module_outputs, out_keys)
      outputs[name] = module_outputs
    outputs['out'] = module_outputs
    return outputs
