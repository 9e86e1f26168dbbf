"""Parallelism: device meshes and time-axis (sequence-parallel) sharding.

Port of ddsp_tpu.parallel. A mesh lies in one process, or spans
torch.distributed ranks, one process per device (`distributed`: the
process group and each rank's run of shards; parallel/mesh.py);
`shard_batch` and `replicate` place a global batch and rank 0's parameters
on the ranks, and
`pallas_halo` becomes `halo` (the neighbour shifts on kernel K3, and its
remote copy between ranks). `make_sp_train_step` is the long-audio step,
`sp_forward_with_losses` the full model's sharded forward (Trainer and the
eval loop reach it when their mesh shards time).
"""

from ddsp_torch.parallel import distributed, halo, sp_model, time_shard
from ddsp_torch.parallel.mesh import (Mesh, create_mesh, replicate,
                                      shard_batch, single_device_mesh)
from ddsp_torch.parallel.sp_model import (has_time_sharding,
                                          sp_forward_with_losses)
from ddsp_torch.parallel.sp_train import (make_sp_train_step,
                                          sp_synth_and_loss)
from ddsp_torch.parallel.time_shard import (time_sharded_fft_convolve,
                                            time_sharded_harmonic_synthesis,
                                            time_sharded_spectral_loss)

__all__ = ['distributed', 'halo', 'sp_model', 'time_shard', 'Mesh',
           'create_mesh', 'replicate', 'shard_batch', 'single_device_mesh', 'has_time_sharding', 'make_sp_train_step',
           'sp_forward_with_losses', 'sp_synth_and_loss',
           'time_sharded_fft_convolve', 'time_sharded_harmonic_synthesis',
           'time_sharded_spectral_loss']
