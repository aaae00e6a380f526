"""Time the weight-only int8 T == 1 kernel (``ops/quant.w8a16_matmul``) on one GPU.

    python3 scripts/w8a16_kernel_times.py [--m 48] [--splits] [--separate]

For each launch of a Janus-Pro-7B and -1B decode step (q, k and v in one
launch; o; gate and up in one; down) and of the DeepSeek-V2-Lite MLA layer
(q with the latent down-projection; o; layer 0's dense gate and up; its
down) at M rows of x (48: 24 CFG pairs), bf16, it reports the device time
from CUDA-graph replay over copies of the weights larger than the 50 MB L2
(``chip_smoke.cuda_ms_graph``), the split of K the wrapper picks, and the
bytes bound (the int8 payload, the fp32 scales, x and y once, at 3.35 TB/s).
With ``--splits`` it also times every split of K from 1 to 8 blocks a
cluster.  With ``--separate`` it also times the matrices of a shared launch
each in a launch of its own (at the split the wrapper picks for it alone),
and sums one decode step's projections both ways.

Writes ``chiprun_out/w8a16_kernel_times.json`` under this checkout and
prints it.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (label, [F...] sharing x, D, launches of it in one decode step)
LAUNCHES = (("7b wq/wk/wv", [4096] * 3, 4096, 30), ("7b wo", [4096], 4096, 30),
            ("7b w_gate/w_up", [11008] * 2, 4096, 30), ("7b w_down", [4096], 11008, 30),
            ("1b wq/wk/wv", [2048] * 3, 2048, 24), ("1b wo", [2048], 2048, 24),
            ("1b w_gate/w_up", [5632] * 2, 2048, 24), ("1b w_down", [2048], 5632, 24),
            ("mla wq/wkv_a", [3072, 576], 2048, 27), ("mla wo", [2048], 2048, 27),
            ("mla dense w_gate/w_up", [10944] * 2, 2048, 1),
            ("mla dense w_down", [2048], 10944, 1))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=48)
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--separate", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from ospo_tpu_torch.ops import quant

    cs = _chip_smoke()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    m, out, steps = args.m, [], {}
    for label, fs, d, per_step in LAUNCHES:
        qws = [quant.quantize_matrix((torch.randn((f, d), generator=g, device=dev)
                                      * 0.02).to(torch.bfloat16)) for f in fs]
        x = torch.randn((m, 1, d), generator=g, device=dev).to(torch.bfloat16)
        nbytes = sum(f * d + 4 * f + 2 * m * f for f in fs) + 2 * m * d
        bound_ms = max(nbytes / cs.PEAK_BYTES, 2.0 * m * d * sum(fs) / cs.PEAK_BF16) * 1e3
        sets = [[{k: t.clone() for k, t in w.items()} for w in qws]
                for _ in range(-(-120_000_000 // nbytes))]
        plan = quant.w8a16_split(m, fs, d)

        def timed(n=None):
            return cs.cuda_ms_graph(
                [lambda w=w: quant.w8a16_matmul(x, w, n) for w in sets], 10 * len(sets))

        row = {"launch": label, "m": m, "f": fs, "d": d, "plan": plan,
               "ms": timed(), "bound_ms": bound_ms}
        if args.splits:
            row["splits"] = {n: timed(n) for n in range(1, min(8, -(-d // 128)) + 1)}
        if args.separate:
            row["separate_ms"] = row["ms"] if len(fs) == 1 else cs.cuda_ms_graph(
                [lambda w=w: [quant.w8a16_matmul(x, [v]) for v in w] for w in sets],
                10 * len(sets))
            step = steps.setdefault(label.split(" ")[0], {"shared_ms": 0.0,
                                                          "separate_ms": 0.0})
            step["shared_ms"] += per_step * row["ms"]
            step["separate_ms"] += per_step * row["separate_ms"]
        row["share_of_bound"] = bound_ms / row["ms"]
        print(json.dumps(row), flush=True)
        out.append(row)
        del sets, qws, x
        torch.cuda.empty_cache()
    if steps:
        print(json.dumps({"one_step_projections": steps}), flush=True)
        out.append({"one_step_projections": steps})
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "w8a16_kernel_times.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
