#!/usr/bin/env bash
# Launch ddsp_torch training, evaluation or sampling across processes, one
# per card, with torchrun.
#
# The counterpart of scripts/launch_tpu_pod.sh for the PyTorch port: where
# JAX runs one process per host and jax.distributed.initialize() reads the
# TPU's topology, PyTorch runs one process per card. torchrun starts them
# and sets RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR / MASTER_PORT;
# `ddsp_torch.run --multihost` starts torch.distributed from them, each
# process takes cuda:LOCAL_RANK, and the ranks form a ('data', 'time') mesh
# (--time_shards N puts N ranks in a data row). --batch_size is each
# process's rows; rank 0 writes checkpoints, summaries and samples.
#
# Usage:
#   ./scripts/launch_torchrun.sh NPROC SAVE_DIR [extra ddsp_torch.run args...]
#
# The run trains unless the arguments hold a --mode: --mode eval or
# --mode sample evaluates or samples SAVE_DIR's checkpoints on the same
# mesh, every rank reading the same eval set (min(--batch_size, 4) rows a
# data row) and rank 0 writing SAVE_DIR/eval or SAVE_DIR/samples.
#
# Examples:
#   ./scripts/launch_torchrun.sh 4 /tmp/run --preset=solo_instrument \
#       --data=tfrecord:/data/train*.tfrecord --batch_size=4
#   ./scripts/launch_torchrun.sh 4 /tmp/run --time_shards 4 --batch_size=2
#   ./scripts/launch_torchrun.sh 4 /tmp/run --time_shards 4 --mode eval \
#       --run_once
#   # Several hosts: the same command on each, with torchrun's rendezvous
#   # flags, e.g. TORCHRUN_ARGS="--nnodes 2 --node_rank 0 \
#   #   --master_addr host0 --master_port 29500".
set -euo pipefail

NPROC="${1:?number of processes (cards) on this host}"
SAVE_DIR="${2:?save dir}"
shift 2

# shellcheck disable=SC2086
exec torchrun --nproc_per_node "${NPROC}" ${TORCHRUN_ARGS:-} \
  -m ddsp_torch.run --multihost --save_dir="${SAVE_DIR}" "$@"
