#!/usr/bin/env bash
# Measurements of the PyTorch port on one NVIDIA GPU, as PERF.md quotes them.
#
#   tools/port_chip_runs.sh PARENT_DIR CHANGE_DIR OUT_DIR
#   tools/port_chip_runs.sh --bf16-matmul PARENT_DIR CHANGE_DIR OUT_DIR
#
# --bf16-matmul measures the bf16 GEMM (kernel #9) alone: tools/bf16_mm_probe.py
# over the trees parent, change, change, parent (PERF.md rows 9-9e, each tree
# in a fresh process), then each shape of rows 9 and 9a alone (parent, change;
# the change's kernel with parts removed), tools/bf16_step_time.py in turns
# (the unsharded bf16 serving step of llama-200m), then the card's test suite
# from CHANGE_DIR; about 14 minutes on the card. Without it:
#
# PARENT_DIR and CHANGE_DIR are checkouts of two commits (for example each
# unpacked with `git archive` into a directory that .gitignore lists). Runs
# chip_smoke.py of each, interleaved as parent, change, change, parent, so
# that drift in the host's load shows on both sides; then tools/quant_probe.py
# (with --train) and tools/mla_probe.py over both trees (parent, change,
# change, parent); then, from CHANGE_DIR,
# the card's test suite and six full-width llama-200m training steps under
# bf16 beside the quartet2 ones of chip_smoke.py. Each run's output goes to
# OUT_DIR/<run>.log, each chip_smoke.json to OUT_DIR/<run>.json. Exits 1 if
# any run failed.
set -u
mode=all
if [ "${1:-}" = "--bf16-matmul" ]; then
    mode=bf16_matmul
    shift
fi
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
mkdir -p "$3"
out=$(cd "$3" && pwd)
status=0

smoke() {  # smoke NAME DIR
    rm -f "$2/chiprun_out/chip_smoke.json"
    (cd "$2" && python3 chip_smoke.py) > "$out/$1.log" 2>&1
    local rc=$?
    echo "$1 rc=$rc"
    tail -n 3 "$out/$1.log" | cut -c 1-300
    cp "$2/chiprun_out/chip_smoke.json" "$out/$1.json" 2>/dev/null
    [ "$rc" -eq 0 ] || status=1
}

cuda_tests() {
    (cd "$change" && python -m pytest --noconftest -p no:cacheprovider -q -m cuda \
        tests/test_torch_cuda.py) > "$out/cuda_tests.log" 2>&1 || status=1
    tail -n 2 "$out/cuda_tests.log"
}

if [ "$mode" = bf16_matmul ]; then
    (cd "$change" && python3 tools/bf16_mm_probe.py --trees "$parent" "$change" \
        "$change" "$parent" --out "$out/bf16_mm_probe.json") \
        > "$out/bf16_mm_probe.log" 2>&1 || status=1
    grep -e "^run " -e "failed" "$out/bf16_mm_probe.log" | cut -c 1-400
    # each shape of rows 9, 9a alone (warm), parent and change in turns, and
    # the change's kernel with one part removed at a time
    (cd "$change" && python3 tools/bf16_mm_probe.py --trees "$parent" "$change" \
        --rows 9 9a --shapes && python3 tools/bf16_mm_probe.py --trees "$change" \
        --rows 9 9a --shapes --variants) > "$out/bf16_mm_shapes.log" 2>&1 || status=1
    grep -e "^run " -e "failed" "$out/bf16_mm_shapes.log" | cut -c 1-300
    i=0
    for tree in "$parent" "$change" "$change" "$parent"; do
        i=$((i + 1))
        (cd "$tree" && PYTHONPATH=src python3 "$change/tools/bf16_step_time.py" \
            --label "run$i:$tree" --json "$out/bf16_step_time.jsonl") \
            > "$out/bf16_step_time_$i.log" 2>&1 || status=1
        grep -v -e "^{" -e Warn -e _warn_once "$out/bf16_step_time_$i.log" | tail -n 2
    done
    cuda_tests
    exit "$status"
fi

smoke parent1 "$parent"
smoke change1 "$change"
smoke change2 "$change"
smoke parent2 "$parent"

# the quantizers: #1's whole call and MS-EDEN phase 1 over each path's step,
# and one profiled training step's launches and device time, parent and
# change interleaved; #1's two large-tensor designs, its regimes around the
# cluster threshold and the kernels' SASS counts (change only)
(cd "$change" && python3 tools/quant_probe.py --trees "$parent" "$change" "$change" \
    "$parent" --train --sass --designs --out "$out/quant_probe.json") \
    > "$out/quant_probe.log" 2>&1 || status=1
grep -v -e Warning -e _warn_once -e "ptxas (coop" "$out/quant_probe.log" | tail -n 40 | cut -c 1-400

# the MLA decode kernels (#7, #8) at phase 3's lengths and at 4 x 4,096
# tokens, parent and change interleaved
(cd "$change" && python3 tools/mla_probe.py --trees "$parent" "$change" "$change" \
    "$parent" --out "$out/mla_probe.json") > "$out/mla_probe.log" 2>&1 || status=1
tail -n 20 "$out/mla_probe.log" | cut -c 1-400

cuda_tests

(cd "$change" && PYTHONPATH=src python -m repro_torch.launch.train --arch llama_200m \
    --scheme bf16 --steps 6 --seq 256 --batch 8 --lr 2e-3 --log-every 1) \
    > "$out/train_bf16.log" 2>&1 || status=1
tail -n 7 "$out/train_bf16.log"
exit "$status"
