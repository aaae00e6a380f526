#!/usr/bin/env bash
# Multi-process launcher of the PyTorch port (ospo_tpu_torch), the
# counterpart of scripts/run_multihost.sh.  Every step CLI of the port
# calls ospo_tpu_torch.platform.maybe_init_distributed() first: each
# process walks its strided share of the work list (io.shard_for_process),
# results merge through io.save_json_sharded (gather on a gloo group,
# rank-0 dedup by item_id), and step 5 averages its gradients over the
# group (pass model.data_parallel=<nprocs>).  Each process drives one card
# (cuda:<rank mod device count>, or OSPO_LOCAL_DEVICE_IDS); the backend is
# gloo for device=cpu or when ranks share a card, else nccl.
#
#   scripts/run_multihost_torch.sh <nprocs> <python-module> [args...]
#
# e.g. two processes of step 2 on the CPU:
#   scripts/run_multihost_torch.sh 2 ospo_tpu_torch.pipeline.step2 \
#       --cfg_path configs/step2.yaml model_path=null model_preset=tiny \
#       device=cpu
#
# The coordinator is localhost on a free port (OSPO_COORD_PORT, or
# OSPO_COORDINATOR=host:port, to choose).  PYTHON names the interpreter
# (python3).  The launcher waits on every process and exits with the first
# nonzero code; when one process fails it kills the others, so that no
# peer waits on a dead coordinator.
set -uo pipefail

if [ $# -lt 2 ]; then
  echo "usage: $0 <nprocs> <python-module> [args...]" >&2
  exit 2
fi

NPROCS=$1; shift
PY=${PYTHON:-python3}
PORT=${OSPO_COORD_PORT:-$("$PY" -c 'import socket; s = socket.socket(); s.bind(("localhost", 0)); print(s.getsockname()[1])')}
COORD=${OSPO_COORDINATOR:-localhost:$PORT}

pids=()
stop() {
  for p in "${pids[@]}"; do kill "$p" 2>/dev/null; done
}
trap 'stop; exit 143' TERM INT

for i in $(seq 0 $((NPROCS - 1))); do
  OSPO_COORDINATOR=$COORD \
  OSPO_NUM_PROCESSES=$NPROCS \
  OSPO_PROCESS_ID=$i \
    "$PY" -m "$@" &
  pids+=($!)
done

rc=0
for _ in "${pids[@]}"; do
  wait -n
  code=$?
  if [ "$code" -ne 0 ] && [ "$rc" -eq 0 ]; then
    rc=$code
    echo "$0: a process exited with code $code; stopping the others" >&2
    stop
  fi
done
exit $rc
