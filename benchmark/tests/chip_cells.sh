#!/bin/bash
# Runs cells of the benchmark on the card, one process a run, in turn:
#   bash benchmark/tests/chip_cells.sh <seconds> <workload> <seed> <trace> [<workload> <seed> <trace> ...]
# Each run's stdout and stderr go to chiprun_out/runs/<n>-<workload>-<seed>-t<trace>.{out,err},
# n counting the runs of the call; its last stdout line and the tail of its stderr are echoed.
set -u
secs=$1; shift
mkdir -p chiprun_out/runs
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
n=0
while [ $# -ge 3 ]; do
  w=$1; s=$2; tr=$3; shift 3
  n=$((n + 1))
  base=chiprun_out/runs/$n-$w-$s-t$tr
  t0=$(date +%s)
  python3 benchmark/run.py --workload "$w" --seed "$s" --seconds "$secs" --trace "$tr" >"$base.out" 2>"$base.err"
  rc=$?
  echo "== $w seed $s trace $tr rc $rc wall $(( $(date +%s) - t0 ))s"
  tail -n 1 "$base.out"
  tail -n 8 "$base.err"
done
exit 0
