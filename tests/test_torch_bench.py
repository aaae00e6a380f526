"""The port's bench entry point, ``python -m ospo_tpu_torch.bench``, at the
tiny preset on the CPU: each mode prints exactly one JSON line with the JAX
``bench.py``'s metric name and unit and a positive value."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = {"step3": ("img-tokens/sec/chip", "tok/s"),
           "train": ("simpo-samples/sec/chip", "samples/s"),
           "text": ("text-tokens/sec/chip", "tok/s"),
           "score": ("pref-pairs/hour/chip", "pairs/h")}


def _bench(*args):
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    return subprocess.run(
        [sys.executable, "-m", "ospo_tpu_torch.bench", "--preset", "tiny",
         "--device", "cpu", *args], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)


@pytest.mark.parametrize("mode", sorted(METRICS))
def test_bench_prints_one_json_line(mode):
    """``--tokens 16`` keeps the decode modes short; the line names the
    preset, the batch and the device, and reports no device memory or card
    on the CPU."""
    out = _bench("--mode", mode, "--tokens", "16")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [x for x in out.stdout.splitlines() if x.strip()]
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    assert (rec["metric"], rec["unit"]) == METRICS[mode]
    assert rec["value"] > 0 and rec["preset"] == "tiny" and rec["batch"] > 0
    assert rec["device"] == "cpu" and rec["max_memory_allocated"] is None


@pytest.mark.parametrize("flags,train_mode,quantize_base", [
    (("--full",), "full", None), (("--quantize", "int8"), "lora", "int8")])
def test_bench_train_variants(flags, train_mode, quantize_base):
    """Full fine-tune and the int8 frozen trunk through the train mode."""
    out = _bench("--mode", "train", *flags)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip())
    assert rec["value"] > 0 and rec["train_mode"] == train_mode
    assert rec["quantize_base"] == quantize_base


def test_bench_fails_without_a_result_line():
    """A failure prints the error and exits non-zero, and no value: an int4
    frozen trunk, which the JAX trainer does not offer either."""
    out = _bench("--mode", "train", "--quantize", "int4")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "quantize_base" in out.stderr
