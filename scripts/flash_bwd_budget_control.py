"""Control run for the rounding budget of the bf16 flash backward kernels.

    python3 scripts/flash_bwd_budget_control.py

On one GPU, the dQ and dK/dV kernels (``ospo_tpu_torch/ops/csrc``) go
through the budget of ``tests/flash_bwd_reference.py`` (RMS error against a
float64 backward at most ``BUDGET`` times the plain backward's) twice: as
built from the sources, and as a control build whose tensor-core body also
rounds the unscaled scores ``q . k`` to bf16 (precision a kernel must not
lose).  The control build is compiled from a patched copy of the sources
under ``build/control/`` (git-ignored); the sources are not touched.

Shapes: the ragged GQA case of ``chip_smoke.py`` (rows 3, T 200, H 4/KVH 2)
and 2 rows of the training shape (T 704, H 32).  Prints one line a tensor
and exits 0 when every tensor of the real build keeps the budget and every
tensor of the control build breaks it.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import flash_bwd_reference as ref  # noqa: E402
from ospo_tpu_torch.ops import build  # noqa: E402
from ospo_tpu_torch.ops import flash_attention as fa  # noqa: E402

KERNELS = ("flash_bwd_dq", "flash_bwd_dkv")
# the score as the shared epilogue reads it, and the control's rounding of it
SCORE = "r.key_valid ? s[nb][e] * scale"
ROUNDED_SCORE = "r.key_valid ? __bfloat162float(__float2bfloat16(s[nb][e])) * scale"


def build_control() -> dict:
    """The two kernels built from a copy of the sources with the scores
    rounded to bf16 → {name: loaded library}."""
    out = build.BUILD_DIR.parent / "control"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out / "csrc")
    header = out / "csrc" / "mma_bf16.cuh"
    text = header.read_text()
    if text.count(SCORE) != 1:
        raise RuntimeError(f"the epilogue's score read {SCORE!r} is not in "
                           f"{header.name} exactly once")
    header.write_text(text.replace(SCORE, ROUNDED_SCORE))
    jobs = {n: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"lib{n}.so"),
         str(out / "csrc" / f"{n}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n in KERNELS}
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the control {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        symbol, argtypes = build.SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = lib
    return libs


@contextlib.contextmanager
def loaded(libs: dict):
    """The wrappers launch ``libs`` inside the block."""
    saved = {n: build._libs.get(n) for n in libs}
    build._libs.update(libs)
    try:
        yield
    finally:
        for name, lib in saved.items():
            if lib is None:
                build._libs.pop(name, None)
            else:
                build._libs[name] = lib


def ratios(rows, T, H, KVH, seed) -> list:
    """[(name, kernel RMS error / plain RMS error)] at one shape."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((rows, T, H, 128), generator=g, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((rows, T, KVH, 128), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    mask = torch.ones((rows, T), dtype=torch.int32, device=dev)
    mask[-1, T // 3] = 0
    args = ref.budget_case(q, k, v, mask, do)
    got = (fa.flash_dq(*args), *fa.flash_dkv(*args))
    out = [(name, err / err_plain)
           for name, err, err_plain in ref.budget(got, *args)]
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"nvidia-smi: {smi.stdout.strip()}")
    build.build_all(KERNELS)
    control = build_control()
    ok = True
    for shape, seed in (((3, 200, 4, 2), 8), ((2, 704, 32, 32), 9)):
        for label, libs in (("kernels", {}), ("control", control)):
            with loaded(libs):
                for name, r in ratios(*shape, seed):
                    keeps = r <= ref.BUDGET
                    ok &= keeps == (label == "kernels")
                    print(f"{label} rows,T,H,KVH={shape} {name}: RMS error "
                          f"ratio {r:.4f} ({'within' if keeps else 'over'} "
                          f"the budget of {ref.BUDGET:g})")
    print("control run " + ("as expected" if ok else "NOT as expected"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
