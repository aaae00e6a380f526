"""Every kernel of a step-3 benchmark cell's traced decode steps, by name,
and the grouped expert kernels against their plain version.

    python3 scripts/profile_step3_cell.py [--workload <step-3 cell> --seed 7] [--experts]

Runs the cell's driver (set-up, a one-group window, the traced group after
it, as ``benchmark/run.py --trace 1`` does) and prints, for the traced
steps, device milliseconds and launches a step of each kernel name, then
the busy time a step.  ``--experts``: times one MoE layer of the cell's
widths (64 routed experts, top-6, 2 shared, D 2048, F 1408) at a decode
step's 48 tokens and a prefill's 6144, replayed from a CUDA graph, median
of 20: ``routed_experts`` whole, the plain version's routing and grouping
(device ops) and each kernel, beside the least time of the touched experts'
bytes or FLOPs; the kernels' routing against the plain routing, and
their output against the plain version's given the kernels' routing, on
the same CUDA tensors.  Card only.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]

import torch  # noqa: E402


def kernels(workload: str, seed: int) -> None:
    import run
    from harness.cell import Cell, Record
    from harness.trace import Tracer

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    w, conf = run.cell_spec(bench, workload)
    config = run.load_json(os.path.join(ROOT, conf["file"]))
    bench_dir = os.path.join(ROOT, "benchmark")
    traffic = run.load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    mod = run.load_module(os.path.join(bench_dir, "drivers", traffic["driver"] + ".py"),
                          "drivers_" + traffic["driver"])
    scratch = tempfile.mkdtemp()
    cell = Cell(name=workload, config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, seed=seed, seconds=1.0,
                trace=True, device=torch.device("cuda"), scratch=scratch,
                record=Record(tracer=Tracer(True, scratch)))
    driver = mod.Driver(cell)
    driver.setup()
    driver.window(1.0)
    tracer = cell.record.tracer
    tracer.stop()
    events, window_s = tracer._events("device")
    steps = cell.record.work["traced_units"]
    ms, n = Counter(), Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ms[e["name"]] += float(e["dur"]) / 1e3
            n[e["name"]] += 1
    busy = sum(ms.values())
    print(f"# {workload}: {steps} traced steps, {sum(n.values()) / steps:.1f} launches a "
          f"step, {busy / steps:.4f} ms of device time a step (kernel sums)")
    for name, t in ms.most_common():
        print(f"{t / steps:9.4f} ms {n[name] / steps:7.2f} x  {name[:110]}")


def _graph_ms(fn, reps: int) -> float:
    """Median device milliseconds of ``fn`` replayed from a CUDA graph."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def experts(reps: int = 20) -> None:
    from ospo_tpu_torch.ops import moe
    from ospo_tpu_torch.ops.quant import quantize_matrix

    dev = torch.device("cuda")
    E, S, D, F, k = 64, 2, 2048, 1408, 6
    g = torch.Generator(device=dev).manual_seed(0)
    w13 = quantize_matrix((torch.randn((E + S, 2 * F, D), generator=g, device=dev)
                           * D ** -0.5).to(torch.bfloat16))
    w2 = quantize_matrix((torch.randn((E + S, D, F), generator=g, device=dev)
                          * F ** -0.5).to(torch.bfloat16))
    router = (torch.randn((E, D), generator=g, device=dev) * D ** -0.5).to(torch.bfloat16)
    counts = torch.zeros(E + S, dtype=torch.int32, device=dev)
    lib = None
    for N in (48, 6144):
        x = torch.randn((N, D), generator=g, device=dev).to(torch.bfloat16)
        rows, bm = N * (k + S), moe.block_m(N * (k + S), E + S)
        topi, topw = moe.with_shared(*moe.route_plain(x, router, k), E, S)
        c, offsets, src, te, ts = moe.align_plain(topi, E + S, bm)
        h = torch.empty((rows, F), dtype=x.dtype, device=dev)
        y = torch.empty((rows, D), dtype=x.dtype, device=dev)
        moe.routed_experts(x, router, w13, w2, k, counts, n_shared=S)
        from ospo_tpu_torch.ops import build

        lib = build.load("moe_experts")
        table = (src.data_ptr(), te.data_ptr(), ts.data_ptr(), offsets.data_ptr())

        def gate_up():
            lib.ospo_moe_gate_up(x.data_ptr(), *table, w13["q"].data_ptr(),
                                 w13["s"].data_ptr(), h.data_ptr(), te.numel(), bm, D, F,
                                 E + S, k + S, torch.cuda.current_stream().cuda_stream)

        def down():
            lib.ospo_moe_down(h.data_ptr(), *table, w2["q"].data_ptr(), w2["s"].data_ptr(),
                              y.data_ptr(), te.numel(), bm, D, F, E + S,
                              torch.cuda.current_stream().cuda_stream)

        def routing():
            moe.align_plain(moe.with_shared(*moe.route_plain(x, router, k), E, S)[0],
                            E + S, bm)

        ti = torch.empty((N, k + S), dtype=torch.int32, device=dev)
        tw = torch.empty((N, k + S), dtype=torch.float32, device=dev)
        o2, s2, r2 = torch.empty_like(offsets), torch.empty_like(src), torch.empty_like(src)
        e2, t2 = torch.empty_like(te), torch.empty_like(ts)

        def route():
            lib.ospo_moe_route(x.data_ptr(), router.data_ptr(), ti.data_ptr(), tw.data_ptr(),
                               N, D, E, k, S, 0, 1.0, 0, E, 0,
                               torch.cuda.current_stream().cuda_stream)

        def align():
            lib.ospo_moe_align(ti.data_ptr(), counts.data_ptr(), o2.data_ptr(), s2.data_ptr(),
                               e2.data_ptr(), t2.data_ptr(), r2.data_ptr(), rows, E + S, bm,
                               te.numel(), torch.cuda.current_stream().cuda_stream)

        parts = {"routed_experts": lambda: moe.routed_experts(x, router, w13, w2, k,
                                                              counts, n_shared=S),
                 "routing (plain ops)": routing, "moe_route": route, "moe_align": align,
                 "moe_gate_up": gate_up, "moe_down": down}
        touched = int((c > 0).sum())
        least = touched * (3 * D * F + 4 * (2 * F + D)) / 3.35e12 * 1e3
        flop_ms = 2 * rows * 3 * D * F / 989e12 * 1e3
        print(f"# experts, one layer at {N} tokens ({rows} rows, tiles of {bm}, "
              f"{touched} experts touched): least time {max(least, flop_ms):.4f} ms "
              f"(bytes {least:.4f}, FLOPs {flop_ms:.4f})")
        for name, fn in parts.items():
            try:
                print(f"#   {name}: {_graph_ms(fn, reps):.4f} ms (graph replay, median "
                      f"of {reps})")
            except RuntimeError as e:
                print(f"#   {name}: not captured ({str(e).splitlines()[0]})")
        got = moe.routed_experts(x, router, w13, w2, k, counts, n_shared=S).float()
        ki, kw = moe.route(x, router, k, n_shared=S)
        differ, shortfall, w_err = moe.routing_gap(x, router, ki, kw, k)
        _, o3, s3, e3, t3 = moe.align_plain(ki, E + S, bm)
        h_p = moe.gate_up_plain(x, s3, o3, e3, t3, w13, k + S, bm)
        want = moe.combine_plain(moe.down_plain(h_p, s3, o3, e3, t3, w2, bm), kw,
                                 x.dtype).float()
        print(f"#   routing against plain: {differ} tokens differ (shortfall "
              f"{shortfall:.2e}), weights max |diff| {w_err:.2e}; kernels against plain "
              f"with the kernels' routing: max |diff| {float((got - want).abs().max()):.3e}"
              f" of max |plain| {float(want.abs().max()):.3e}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--experts", action="store_true")
    args = ap.parse_args()
    if args.workload:
        kernels(args.workload, args.seed)
    if args.experts:
        experts()


if __name__ == "__main__":
    main()
