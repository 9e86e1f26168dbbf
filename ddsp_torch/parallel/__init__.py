"""Parallelism: device meshes and time-axis (sequence-parallel) sharding.

Port of ddsp_tpu.parallel for one controlling process (parallel/mesh.py):
the JAX package's NamedSharding helpers, `shard_batch` and `replicate` have
nothing to place here, `pallas_halo` becomes `halo` (the neighbour shifts on
kernel K3), and `make_sp_train_step` waits in ROADMAP.md queue 1 item 8.
"""

from ddsp_torch.parallel import halo, sp_model, time_shard
from ddsp_torch.parallel.mesh import Mesh, create_mesh, single_device_mesh
from ddsp_torch.parallel.sp_model import (has_time_sharding,
                                          sp_forward_with_losses)
from ddsp_torch.parallel.sp_train import sp_synth_and_loss
from ddsp_torch.parallel.time_shard import (time_sharded_fft_convolve,
                                            time_sharded_harmonic_synthesis,
                                            time_sharded_spectral_loss)

__all__ = ['halo', 'sp_model', 'time_shard', 'Mesh', 'create_mesh',
           'single_device_mesh', 'has_time_sharding',
           'sp_forward_with_losses', 'sp_synth_and_loss',
           'time_sharded_fft_convolve', 'time_sharded_harmonic_synthesis',
           'time_sharded_spectral_loss']
