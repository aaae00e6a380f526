"""Time the port's int4 decode matmuls at the 7B projection shapes, on one GPU.

    python3 scripts/int4_kernel_times.py [--root DIR] [--label NAME] [--m 48] [--splits]

Imports ``ospo_tpu_torch`` from ``--root`` (default: this checkout), so the
same measurement runs on another tree of the repository, for example a
``git archive`` of the parent commit unpacked under ``build/``.  For each
mode (``int4``: the row kernel, ``int4g``: the group kernel) and each shape
of a Janus-Pro-7B decode projection (F x D = 4096 x 4096, 11008 x 4096,
4096 x 11008) at M rows of x (48: 24 CFG pairs), bf16, it checks the kernel
against its plain version (max |diff|) and reports device times from
CUDA-graph replay (``chip_smoke.cuda_ms_graph``: no host launch cost in the
time):

- ``cold_ms``: cycling over copies of the weight larger than the 50 MB L2,
  as a decode step reads each weight; ``hot_ms``: one weight, back to back;
- ``cublas_cold_ms`` / ``cublas_hot_ms``: ``x @ W^T`` on the weight
  dequantized to bf16 (a yardstick that reads 4x the weight bytes);
- ``bound_ms``: bytes (packed weight, scales, x, y) over 3.35 TB/s, or
  FLOPs over 989 TFLOP/s, whichever is larger.

With ``--splits`` (this tree only) it also prints how many clusters of n
blocks the card holds at once (``cudaOccupancyMaxActiveClusters``, the
wrapper's plan) and times the bf16 body, cold, with every split of D from 1
to 8 blocks, calling the library directly.

Writes ``chiprun_out/int4_kernel_times_<label>.json`` under this checkout and
prints it.  Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"wq/wk/wv/wo": (4096, 4096), "w_gate/w_up": (11008, 4096),
          "w_down": (4096, 11008)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sweep(cs, i4, mode, qw, x, copies):
    """Cold time of the bf16 body with each split of D (1..8 blocks a
    cluster), through the library's entry point."""
    from ospo_tpu_torch.ops import build

    name = "int4_matmul_group" if mode == "int4g" else "int4_matmul_row"
    fn = getattr(build.load(name), build.SIGNATURES[name][0])
    m, d = x.shape[0], x.shape[2]
    f2 = qw["q4"].shape[0]
    qws = [{k: t.clone() for k, t in qw.items()} for _ in range(copies)]

    def call(q, n):
        y = torch.empty((m, 1, 2 * f2), dtype=x.dtype, device=x.device)
        scale = q["gs"] if mode == "int4g" else q["s"]
        head = (x.data_ptr(), q["q4"].data_ptr(), scale.data_ptr(),
                y.data_ptr(), y.data_ptr(), m, f2, d)
        groups = (scale.shape[-1],) if mode == "int4g" else ()
        stream = torch.cuda.current_stream().cuda_stream
        build.check(fn(*head, *groups, 0, n, 1, stream), name)
        return y

    times = {}
    for n in range(1, min(8, -(-d // i4.CHUNK)) + 1):
        times[n] = cs.cuda_ms_graph([lambda q=q, n=n: call(q, n) for q in qws],
                                    10 * copies)
    return {"mode": mode, "F": 2 * f2, "D": d, "M": m,
            "plan": i4._clusters(m, f2, d, i4._card_capacity(
                name, build.load(name), m, x.device)),
            "cold_ms_by_split": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this")
    ap.add_argument("--m", type=int, default=48)
    ap.add_argument("--splits", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int4_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(args.root))
    from ospo_tpu_torch.ops import int4_matmul as i4
    from ospo_tpu_torch.ops import quant

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dequant = {"int4": quant.dequantize_matrix_int4,
               "int4g": quant.dequantize_matrix_int4_group}
    rows, sweeps = [], []
    m = args.m
    if args.splits:
        from ospo_tpu_torch.ops import build

        for name in ("int4_matmul_row", "int4_matmul_group"):
            cap = i4._card_capacity(name, build.load(name), m, dev)
            print(f"{name}: clusters of n blocks held at once "
                  f"{ {n: cap(n) for n in range(1, 9)} }", flush=True)
    for mode in ("int4", "int4g"):
        g = torch.Generator(device=dev).manual_seed(11)
        for label, (f, d) in SHAPES.items():
            w = (torch.randn((f, d), generator=g, device=dev) * 0.02
                 ).to(torch.bfloat16)
            qw = quant.quant_fn(mode)(w)
            del w
            x = torch.randn((m, 1, d), generator=g, device=dev).to(torch.bfloat16)
            err = float((i4.int4_matmul_decode(x, qw).float()
                         - i4.int4_matmul_decode_plain(x, qw).float()).abs().max())
            scale_bytes = sum(t.numel() * 4 for k, t in qw.items() if k != "q4")
            copies = -(-120_000_000 // (f // 2 * d + scale_bytes))
            qws = [{k: t.clone() for k, t in qw.items()} for _ in range(copies)]
            hot = cs.cuda_ms_graph([lambda: i4.int4_matmul_decode(x, qw)], 50)
            cold = cs.cuda_ms_graph([lambda q=q: i4.int4_matmul_decode(x, q)
                                     for q in qws], 10 * copies)
            del qws
            wb = dequant[mode](qw, torch.bfloat16)
            x2 = x[:, 0]
            lib_hot = cs.cuda_ms_graph([lambda: x2 @ wb.T], 50)
            wbs = [wb.clone() for _ in range(-(-120_000_000 // wb.nbytes))]
            lib_cold = cs.cuda_ms_graph([lambda w=w: x2 @ w.T for w in wbs],
                                        10 * len(wbs))
            del wb, wbs
            if args.splits:
                sweeps.append(_sweep(cs, i4, mode, qw, x, copies))
                print(json.dumps(sweeps[-1]), flush=True)
            nbytes = f // 2 * d + scale_bytes + m * d * 2 + m * f * 2
            flops = 2.0 * m * f * d
            bound = max(nbytes / cs.PEAK_BYTES, flops / cs.PEAK_BF16) * 1e3
            rows.append({"mode": mode, "shape": label, "F": f, "D": d, "M": m,
                         "max_abs_err": err, "cold_ms": cold, "hot_ms": hot,
                         "cublas_cold_ms": lib_cold, "cublas_hot_ms": lib_hot,
                         "bound_ms": bound,
                         "pct_of_bound_cold": 100 * bound / cold})
            print(json.dumps(rows[-1]), flush=True)
            del qw, x
            torch.cuda.empty_cache()
    out = {"label": args.label, "root": os.path.abspath(args.root),
           "card": card, "device": torch.cuda.get_device_name(0), "rows": rows,
           "splits": sweeps}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    path = os.path.join(HERE, "chiprun_out", f"int4_kernel_times_{args.label}.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"card: {card}; wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
