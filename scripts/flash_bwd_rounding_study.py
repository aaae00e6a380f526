"""What rounding p and ds to bf16 costs the flash backward, on the CPU.

    python3 scripts/flash_bwd_rounding_study.py

For bf16 inputs at two shapes (rows 3, T 200, GQA 4/2; rows 3, T 704, MHA
4), q scaled by 1, 2 and 3, and four seeds, prints for the bf16 kernels'
scheme (``tests/flash_bwd_reference.py``: p and ds rounded to bf16) and for
the budget's control (the scores rounded as well):

- the max and the RMS error against a float64 backward, each over the same
  error of the plain backward (p and ds in fp32);
- (max |d| - 2^-7 |ref|) / max|ref| against the plain backward, which the
  card tolerance 2^-8 max|ref| + 2^-7 |ref| bounds by 2^-8.

Each line gives the range over the three gradients and the four seeds.
"""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import flash_bwd_reference as ref  # noqa: E402


def case(b, t, h, kvh, scale, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g).to(torch.bfloat16)
                   for shape in ((b, t, h, 128), (b, t, kvh, 128),
                                 (b, t, kvh, 128), (b, t, h, 128)))
    mask = torch.ones((b, t), dtype=torch.int32)
    mask[-1, t // 3] = 0
    q = (q.float() * (scale / ref.Q_SCALE)).to(torch.bfloat16)
    return ref.budget_case(q, k, v, mask, do)


def main() -> int:
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    for shape in ((3, 200, 4, 2), (3, 704, 4, 4)):
        for scale in (1.0, 2.0, 3.0):
            stats = {"scheme": [], "control": []}
            for seed in range(4):
                args = case(*shape, scale, seed)
                plain = ref.backward(*args)
                exact = ref.exact_backward(*args[:5])
                for label, round_s in (("scheme", False), ("control", True)):
                    got = ref.backward(*args, round_p_ds=True, round_s=round_s)
                    for a, p, e in zip(got, plain, exact):
                        a, p = a.to(torch.bfloat16), p.to(torch.bfloat16)
                        err, err_p = (a.double() - e).abs(), (p.double() - e).abs()
                        d = (a.float() - p.float()).abs() - 2 ** -7 * p.float().abs()
                        stats[label].append((
                            float(err.max() / err_p.max()),
                            float(err.pow(2).mean().sqrt()
                                  / err_p.pow(2).mean().sqrt()),
                            float(d.max() / p.float().abs().max())))
            for label, rows in stats.items():
                lo = [min(r[i] for r in rows) for i in range(3)]
                hi = [max(r[i] for r in rows) for i in range(3)]
                print(f"rows,T,H,KVH={shape} q x{scale:g} {label:7s}: max ratio "
                      f"{lo[0]:.3f}-{hi[0]:.3f}, RMS ratio {lo[1]:.3f}-"
                      f"{hi[1]:.3f}, tolerance use {hi[2]:.2e} (limit "
                      f"{2 ** -8:.2e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
