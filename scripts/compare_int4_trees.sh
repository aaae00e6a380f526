#!/bin/bash
# Parent against this tree on one GPU, in turns (parent, this, this, parent):
# the int4 decode-matmul kernels at the 7B shapes (scripts/int4_kernel_times.py)
# and the mid-decode breakdown of step 3 with int4g and int4 weights
# (scripts/profile_torch_step3.py, each tree's own copy).
#
#   bash scripts/compare_int4_trees.sh PARENT_DIR
#
# PARENT_DIR holds another tree of this repository, e.g. a `git archive` of
# the parent commit unpacked under build/ (git-ignored).  Results go to
# chiprun_out/ab/ of this checkout.
set -u
PARENT=$(cd "$1" && pwd)
ROOT=$(cd "$(dirname "$0")/.." && pwd)
OUT="$ROOT/chiprun_out/ab"
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
i=0
for label in parent this this parent; do
  i=$((i + 1))
  tree=$ROOT; [ "$label" = parent ] && tree=$PARENT
  echo "== run $i: $label ($tree)"
  extra=""; [ "$i" = 2 ] && extra="--splits"
  python3 "$ROOT/scripts/int4_kernel_times.py" --root "$tree" --label "${i}_$label" $extra \
    > "$OUT/kernels_${i}_$label.log" 2>&1 || echo "kernel times failed: run $i"
  tail -n 1 "$OUT/kernels_${i}_$label.log"
  for q in int4g int4; do
    (cd "$tree" && python3 scripts/profile_torch_step3.py --quantize "$q" \
      > "$OUT/profile_${q}_${i}_$label.log" 2>&1 \
      && cp chiprun_out/profile_step3_$q.json "$OUT/profile_${q}_${i}_$label.json") \
      || echo "profile $q failed: run $i"
  done
done
mv "$ROOT"/chiprun_out/int4_kernel_times_*.json "$OUT/" 2>/dev/null
ls "$OUT"
