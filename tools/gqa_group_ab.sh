#!/bin/bash
# The paged GQA decode kernels (#5, #6) at the registry's group sizes in two
# checkouts, on one card, in turns: parent, change, change, parent.
#
#     bash tools/gqa_group_ab.sh PARENT_DIR CHANGE_DIR
#
# Each turn is a fresh process in that checkout: it builds (or reuses) the
# checkout's kernels and runs its own chip_smoke.phase_group_kernels (12b:
# H/KV 4, 6, 16 and 1 at hd 128, Sq 1 and 16, both pools, held against the
# plain versions; one decode step's calls timed with events and the
# profiler). Prints the timing lines of each turn and the card's name and
# power limit.
set -euo pipefail
parent=$1
change=$2
for dir in "$parent" "$change" "$change" "$parent"; do
  echo "=== $dir"
  (cd "$dir" && python3 -c "
import sys, time
import torch
sys.path.insert(0, '.'); sys.path.insert(0, 'src')
import chip_smoke as cs
from repro_torch.kernels import build
t0 = time.time(); build.library(); print('build', round(time.time() - t0, 1))
cs.phase_group_kernels(torch)
" 2>&1 | grep -E "^build|calls/step|H/KV")
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
