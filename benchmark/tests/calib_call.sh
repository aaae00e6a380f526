#!/bin/bash
# The readings that the limits of correct are set from, on the card (one
# process a cell; see calibrate.py).  Each line may be run on its own.
set -u
python3 benchmark/tests/calibrate.py --workload janus-pro-7b.step5-lora --seeds 12 \
    --first 6000000000 2>&1 | grep -E '^\{|Error'
python3 benchmark/tests/calibrate.py --workload janus-pro-7b.step3 --seeds 12 --control 3 \
    --first 5100000000 2>&1 | grep -E '^\{|Error'
python3 benchmark/tests/calibrate.py --workload janus-pro-7b.step5-lora --seeds 3 --no-program \
    --variants control_int8,control_w8a8,fault_state_unchanged,fault_half_batch \
    --first 6100000000 2>&1 | grep -E '^\{|Error'
python3 benchmark/tests/calibrate.py --workload janus-pro-1b.step4b --seeds 12 --control 3 \
    --first 7100000000 2>&1 | grep -E '^\{|Error'
python3 benchmark/tests/calibrate.py --workload janus-pro-7b.step5-lora --seeds 6 \
    --first 6200000000 2>&1 | grep -E '^\{|Error'
python3 benchmark/tests/calibrate.py --workload janus-pro-7b.step5-lora --seeds 3 --no-program \
    --variants control_int8,control_w8a8 --first 6300000000 2>&1 | grep -E '^\{|Error'
