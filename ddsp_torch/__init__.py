"""ddsp_torch: the PyTorch + CUDA port of ddsp_tpu for NVIDIA Hopper.

The package mirrors ddsp_tpu's layout (ops/, proc/, nn/, losses/, models/,
configs/, train/, infer/, parallel/, utils/) so each module's counterpart is
easy to find. Hand-written CUDA kernels live in csrc/ (sources) and kernels/ (their
Python wrappers, each beside a plain PyTorch version of the same function).

Entry points (utils.build_model, infer.AutoencoderInference, train.Trainer)
run on CUDA unless the caller passes device='cpu'; without a GPU they raise
rather than quietly running on the CPU. `ops` is the flat namespace of
the DSP functions, as `ddsp_tpu.ops` is.
"""

from ddsp_torch import ops
from ddsp_torch.utils.device import resolve_device

__all__ = ['ops', 'resolve_device']
