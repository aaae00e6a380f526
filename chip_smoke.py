"""Drive the PyTorch/CUDA port (``ospo_tpu_torch``) on one GPU, end to end.

    python3 chip_smoke.py

Phases (the script exits non-zero, without its final result line, if any
fails):

1. environment: the card's name and power limit; build every CUDA kernel
   from ``ospo_tpu_torch/ops/csrc`` (one nvcc per source, in parallel);
2. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with timings (kernel, plain version, one library call
   where one computes the same function, or for the int4 matmuls the
   cuBLAS bf16 product on the dequantized weight as a yardstick) and the
   card's lower bound;
3. a small model (head dim 128) on the GPU (kernels) and on the CPU (plain
   versions), same weights: the teacher-forced CFG probe with int8 and
   with int4g weights, and one SimPO training step (loss and LoRA
   gradients); then the same model in bf16, one training step on the GPU
   through the backward kernels and once more with the plain backward;
4. the step-3 main path: ``ospo_tpu_torch.pipeline.step3.main`` on the
   serving configuration (``configs/step3.yaml``) at the full Janus-Pro-7B
   width (random int8 weights), 24 prompt items; its kernels' launch
   counters must move, and the PNG tree must hold real images;
5. the step-5 main path: ``ospo_tpu_torch.pipeline.step5.main`` on
   ``configs/step5.yaml`` at the 7B width (random bf16 trunk) with
   ``attn_impl: flash``, 3 optimizer steps over the 21 records of
   ``tests/fixtures/examples/step4/train.json`` whose images phase 4 wrote;
   the flash forward, dQ and dK/dV counters must match 30 layers (the
   forward twice under remat) per micro-step, and the checkpoint must land;
6. step 3 as in phase 4 with ``quantize: int4g`` over one group of 24 CFG
   pairs (the first prompt of the first 24 items): the group kernel must
   launch 7 x 30 x 575 times, and the tree must hold 24 real images;
7. the same with ``quantize: int4`` and the row kernel.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "examples", "step2",
                       "long_prompt.json")
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "examples", "step4",
                             "train.json")
N_ITEMS = 24

# configs/step3.yaml as a dict (a CPU test holds the two equal)
STEP3_CONFIG = {
    "seed_list": [0, 1, 2],
    "world_size": None,
    "batch_size": 24,
    "num_workers": None,
    "data_path": None,
    "save_path": "./outputs/step3",
    "ckpt_path": None,
    "model_path": "./checkpoints/Janus-Pro-7B",
    "model_preset": None,
    "cache_dir": "./checkpoints/hf_cache",
    "generation_config": {"parallel_size": 1, "temperature": 1.0,
                          "cfg_weight": 5.0},
    "quantize": "int8",
    "kv_quant": "int8",
    "kv_layout": "shbd",
    "decode_segments": 8,
    "drop_lm_head": True,
    "drop_understanding": True,
}

# configs/step5.yaml as a dict (a CPU test holds the two equal)
STEP5_CONFIG = {
    "base": {"save_path": "./outputs/step5", "exp_name": "ospo",
             "world_size": None, "resume": None},
    "model": {"model_path": "./checkpoints/Janus-Pro-7B", "model_preset": None,
              "cache_dir": "./checkpoints/hf_cache"},
    "use_peft": True,
    "lora": {"lora_rank": 32, "lora_alpha": 64, "lora_dropout": 0.05,
             "target_modules": ["q_proj", "k_proj", "v_proj", "o_proj",
                                "gate_proj", "down_proj", "up_proj"],
             "modules_to_save": None},
    "dataset": {"train": {"batch_size": 16, "num_workers": 4,
                          "data_path": "./outputs/step4/train.json",
                          "num_samples": None},
                "val": {"batch_size": 1, "num_workers": 1}},
    "optimizer": {"init_lr": "4e-5", "betas": [0.9, 0.95], "weight_decay": 0.0,
                  "eps": "1e-8", "scheduler_type": "constant",
                  "min_lr": "1e-6"},
    "experiment": {"seed": 42, "precision": "bf16", "warmup_ratio": 0.0,
                   "gradient_clip_val": 1.0, "enable_checkpointing": True,
                   "gradient_checkpointing": True, "quantize_base": False,
                   "gradient_accumulation_steps": None,
                   "max_training_steps": 1000, "max_epochs": 1,
                   "save_steps": 500, "log_steps": 10, "val_steps": None,
                   "freeze": {"vision_model": True, "aligner": True,
                              "gen_vision_model": True, "gen_aligner": True,
                              "gen_head": True, "gen_embed": True,
                              "language_model": False}},
    "tokenizer": {"max_length": 2048, "max_prompt_length": 1024,
                  "truncation_mode": "keep_end", "truncation_side": "left",
                  "label_pad_token_id": -100},
    "algo": {"beta": 10, "gamma_beta_ratio": 0.5, "sft_weight": 0.0,
             "label_smoothing": 0.0, "loss_type": "sigmoid"},
}


def step5_overrides(data_path: str, image_root: str, save_path: str) -> dict:
    """What phase 5 changes in ``STEP5_CONFIG``: a random-init 7B model
    (``model_path`` unset, as the random-init opt-in requires), the flash
    attention path, 3 optimizer steps over at most 2 epochs, no periodic
    save, and where the data, images and outputs are."""
    return {"model": {"model_path": None, "model_preset": "7b"},
            "experiment": {"attn_impl": "flash", "max_training_steps": 3,
                           "max_epochs": 2, "save_steps": None},
            "dataset": {"train": {"data_path": data_path}},
            "image_root": image_root,
            "base": {"save_path": save_path}}


def merged(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(base[k], v) if isinstance(v, dict) and isinstance(
            base.get(k), dict) else v
    return out


# H100 SXM data-sheet peaks (dense): bf16 tensor cores, int8 tensor cores,
# HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


class Smoke:
    def __init__(self, workdir: str):
        self.failures = []
        self.kernels = {}
        self.workdir = workdir          # phase 4 writes PNGs, phase 5 reads
        self.text_bucket = train_bucket()
        self.launches = {}              # kernel → launches in the main paths
        self.train_kernel_ms = {}       # phase 2's times at the training shape

    def check(self, ok: bool, what: str) -> None:
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)

    def phase(self, name, fn) -> None:
        print(f"== {name}", flush=True)
        t0 = time.time()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            self.failures.append(f"{name}: exception")
        print(f"== {name}: {time.time() - t0:.1f} s", flush=True)

    # -- phase 1 ---------------------------------------------------------
    def environment(self):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(f"nvidia-smi: {smi.stdout.strip()}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}")
        from ospo_tpu_torch.ops import build

        t0 = time.time()
        logs = build.build_all()
        print(f"kernels built in {time.time() - t0:.1f} s")
        spills = []
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
                if "spill" in line and "0 bytes spill stores, 0 bytes spill " \
                        "loads" not in line and name.startswith("flash_bwd"):
                    spills.append(f"{name}: {line.strip()}")
        reports = [n for n in ("flash_bwd_dq", "flash_bwd_dkv")
                   if "spill" in logs.get(n, "")]
        self.check(len(reports) == 2 and not spills,
                   f"flash backward kernels build without register spills "
                   f"(ptxas reports of {reports}): {spills}")

    # -- phase 2 ---------------------------------------------------------
    def flash_kernel(self):
        from ospo_tpu_torch.ops import flash_attention as fa

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(0)
        B, T, H, D = 48, 384, 32, 128
        q, k, v = (torch.randn((B, T, H, D), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        lens = torch.randint(64, T + 1, (B,), generator=g, device=dev)
        lens[0] = T
        mask = (torch.arange(T, device=dev)[None, :] >= (T - lens)[:, None]
                ).to(torch.int32).contiguous()
        out, l, m = fa.flash_attention(q, k, v, mask, causal=True,
                                       return_stats=True)
        ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, mask, causal=True)
        torch.cuda.synchronize()
        errs = [max_err(out, ref), max_err(l, l_ref) / float(l_ref.abs().max()),
                max_err(m, m_ref)]
        # fp32 on both sides from the same bf16 inputs: O differs by the
        # final bf16 rounding (1 ulp = 2^-8 relative), l and m by fp32
        # summation order
        ok = (torch.allclose(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
              and errs[1] < 1e-5 and errs[2] < 1e-4)
        self.check(ok, f"flash bf16 B={B} T=S={T} H={H} causal, left-padded: "
                       f"max|dO|={errs[0]:.3g} (tol 1e-2+1e-2|O|), "
                       f"max|dl|/|l|={errs[1]:.3g} (tol 1e-5), "
                       f"max|dm|={errs[2]:.3g} (tol 1e-4)")

        # fp32, GQA, non-causal: exercises the other paths of the kernel
        g2 = torch.Generator(device=dev).manual_seed(1)
        q2 = torch.randn((3, 200, 8, D), generator=g2, device=dev)
        k2, v2 = (torch.randn((3, 200, 2, D), generator=g2, device=dev)
                  for _ in range(2))
        mask2 = torch.ones((3, 200), dtype=torch.int32, device=dev)
        mask2[1, :37] = 0
        for causal in (False, True):
            o2 = fa.flash_attention(q2, k2, v2, mask2, causal=causal)
            r2 = fa.flash_attention_plain(q2, k2, v2, mask2, causal=causal)[0]
            e2 = max_err(o2, r2)
            self.check(e2 < 1e-4, f"flash fp32 GQA 8/2 causal={causal}: "
                                  f"max|dO|={e2:.3g} (tol 1e-4)")

        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, mask, causal=True), 20)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, mask), 3, 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        allowed = (mask[:, None, None, :] > 0) & torch.ones(
            (T, T), dtype=torch.bool, device=dev).tril()[None, None]
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allowed), 20)
        n = lens.double()
        flops = 4.0 * H * D * float((n * (n + 1) / 2).sum())
        nbytes = 4 * B * T * H * D * 2 + B * T * 4 + 2 * B * H * T * 4
        bound_ms = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
        print(f"flash_fwd: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
        self.kernels["flash_fwd"] = {
            "name": "flash_fwd", "route": "cuda",
            "source": "ospo_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "ospo_tpu/ops/flash_attention.py:45",
            "launches": None, "max_abs_err": errs[0], "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_BF16 > nbytes / PEAK_BYTES
            else "bytes",
            "library_ms": lib_ms,
        }

    def decode_kernel(self):
        from ospo_tpu_torch.ops import decode_attention as da

        dev = torch.device("cuda")
        L, S, H, B, dh = 30, 960, 32, 48, 128
        g = torch.Generator(device=dev).manual_seed(2)
        q = torch.randn((B, 1, H, dh), generator=g, device=dev).to(torch.bfloat16)
        prompt = torch.randint(100, 385, (B,), generator=g, device=dev)
        pos = torch.arange(S, device=dev)[None, :]
        # left-padded 384-token prompt window, then image rows; row 3 has
        # every key masked
        mask = ((pos >= 384 - prompt[:, None]) | (pos >= 384)).to(torch.int32)
        mask[3] = 0
        mask = mask.contiguous()
        worst = 0.0
        timing = None
        for kind in ("int8", "bf16"):
            if kind == "int8":
                kc = torch.randint(-127, 128, (L, S, H, B, dh), generator=g,
                                   device=dev, dtype=torch.int8)
                vc = torch.randint(-127, 128, (L, S, H, B, dh), generator=g,
                                   device=dev, dtype=torch.int8)
                ks = torch.rand((L, S, H, B), generator=g, device=dev) * 0.02
                vs = torch.rand((L, S, H, B), generator=g, device=dev) * 0.02
            else:
                kc = torch.randn((L, S, H, B, dh), generator=g, device=dev,
                                 dtype=torch.bfloat16)
                vc = torch.randn((L, S, H, B, dh), generator=g, device=dev,
                                 dtype=torch.bfloat16)
                ks = vs = None
            # cur_len 385 and 449 end in a one-position chunk: there the last
            # key (an image row, valid in every row but the masked one)
            # dominates the softmax and its V is distinctive, so a kernel
            # that dropped or mis-scaled it would be off by ~3
            tails = {(7, 385), (11, 449)}
            for layer, cur in tails:
                _dominant_last_key(q, kc, vc, ks, vs, layer, cur)
            for layer, cur in ((0, 1), (29, 64), (7, 385), (11, 449),
                               (15, 672), (3, 960)):
                out = da.decode_attention(q, kc, vc, layer, cur, mask, ks, vs)
                ref = da.decode_attention_plain(q, kc, vc, layer, cur, mask, ks, vs)
                err = max_err(out, ref)
                # fp32 on both sides: the bf16 outputs differ by at most one
                # rounding step (2^-7 |ref|), plus fp32 summation order
                ok = torch.allclose(out.float(), ref.float(), atol=1e-4,
                                    rtol=2 ** -7)
                if (layer, cur) in tails:
                    # the plain version itself: valid rows follow the last V
                    last = vc[layer, cur - 1].float().permute(1, 0, 2)
                    if vs is not None:
                        last = last * vs[layer, cur - 1].T[..., None]
                    rows = mask[:, cur - 1] > 0
                    ok = ok and torch.allclose(ref[rows, 0].float(), last[rows],
                                               atol=1e-2, rtol=1e-2)
                self.check(ok, f"decode {kind} cache L={L} S={S} H={H} B={B} "
                               f"layer {layer} cur_len {cur}"
                               f"{' (dominant last key)' if (layer, cur) in tails else ''}"
                               f": max|d|={err:.3g} (tol 1e-4+2^-7|ref|)")
                worst = max(worst, err)
            ref_row = da.decode_attention_plain(q, kc, vc, 15, 672, mask, ks, vs)
            self.check(bool(torch.isfinite(ref_row[3]).all()),
                       f"decode {kind}: fully masked row is finite")
            cur = 672  # mid-decode of a 384-token prompt
            ms = cuda_ms(lambda: da.decode_attention(q, kc, vc, 15, cur, mask,
                                                     ks, vs), 50)
            plain_ms = cuda_ms(lambda: da.decode_attention_plain(
                q, kc, vc, 15, cur, mask, ks, vs), 3, 1)
            elt = kc.element_size()
            nbytes = (2 * cur * H * B * dh * elt + (2 * cur * H * B * 4 if ks is not None else 0)
                      + 2 * B * H * dh * 2 + B * cur * 4)
            ops = 4.0 * cur * H * B * dh
            peak = PEAK_INT8 if kind == "int8" else PEAK_BF16
            bound_ms = max(nbytes / PEAK_BYTES, ops / peak) * 1e3
            print(f"decode_attention {kind} cur_len {cur}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
                  f"({nbytes / 1e6:.1f} MB, {nbytes / ms / 1e6:.1f} GB/s)")
            if kind == "int8":
                timing = (ms, plain_ms, bound_ms,
                          "bytes" if nbytes / PEAK_BYTES > ops / peak
                          else "operations")
            del kc, vc, ks, vs
            torch.cuda.empty_cache()
        self.kernels["decode_attention"] = {
            "name": "decode_attention", "route": "cuda",
            "source": "ospo_tpu_torch/ops/csrc/decode_attention.cu",
            "replaces": "ospo_tpu/ops/decode_attention.py:58",
            "launches": None, "max_abs_err": worst, "ms": timing[0],
            "plain_ms": timing[1], "bound_ms": timing[2],
            "bound_by": timing[3], "library_ms": None,
        }

    def flash_backward_kernels(self):
        from ospo_tpu_torch.ops import flash_attention as fa

        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import flash_bwd_reference as ref

        dev = torch.device("cuda")
        worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def case(rows, T, H, KVH, dtype, masked, seed, what):
            """Inputs of the backward at one shape, with m, l and di from the
            plain forward; the forward kernel is held against it first, so a
            forward wrong at this shape cannot hide behind the backward."""
            g = torch.Generator(device=dev).manual_seed(seed)
            q, do = (torch.randn((rows, T, H, 128), generator=g, device=dev)
                     .to(dtype) for _ in range(2))
            k, v = (torch.randn((rows, T, KVH, 128), generator=g, device=dev)
                    .to(dtype) for _ in range(2))
            mask = torch.ones((rows, T), dtype=torch.int32, device=dev)
            if masked:
                mask[-1, T // 3] = 0
            out, l, m = fa.flash_attention(q, k, v, mask, return_stats=True)
            ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, mask)
            torch.cuda.synchronize()
            errs = [max_err(out, ref),
                    max_err(l, l_ref) / float(l_ref.abs().max()),
                    max_err(m, m_ref)]
            # as phase 2's forward check: O by the final rounding (bf16: one
            # ulp, 2^-8 relative), l and m by fp32 summation order
            o_tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
            ok = (torch.allclose(out.float(), ref.float(), atol=o_tol,
                                 rtol=o_tol if dtype == torch.bfloat16 else 0)
                  and errs[1] < 1e-5 and errs[2] < 1e-4)
            self.check(ok, f"flash_fwd {what}: max|dO|={errs[0]:.3g} (tol "
                           f"{o_tol:g}{'+1e-2|O|' if o_tol == 1e-2 else ''}), "
                           f"max|dl|/|l|={errs[1]:.3g} (tol 1e-5), "
                           f"max|dm|={errs[2]:.3g} (tol 1e-4)")
            worst["fwd"] = max(worst["fwd"], errs[0])
            del out, l, m
            return (q, k, v, mask, do, m_ref, l_ref, fa.row_dot(ref, do))

        def check(args, what):
            """Each gradient against the plain version (p and ds in fp32,
            as the TPU kernels keep them).  fp32 (CUDA-core body): within
            1e-4 + 2^-7 |ref|, the order of the fp32 sums.  bf16 (tensor
            cores, p and ds rounded to bf16): within 2^-8 max|ref| + 2^-7
            |ref|, the final bf16 step plus what the rounding of p and ds
            moves (a share of the row's scale)."""
            dq = fa.flash_dq(*args)
            dk, dv = fa.flash_dkv(*args)
            torch.cuda.synchronize()
            bf16 = args[0].dtype == torch.bfloat16
            for name, got, ref in (("dq", dq, fa.flash_dq_plain(*args)),) + tuple(
                    zip(("dk", "dv"), (dk, dv), fa.flash_dkv_plain(*args))):
                err = max_err(got, ref)
                top = float(ref.float().abs().max())
                atol = 2 ** -8 * top if bf16 else 1e-4
                ok = bool(torch.allclose(got.float(), ref.float(), atol=atol,
                                         rtol=2 ** -7))
                # the largest excess over the 2^-7 |ref| term, against atol
                excess = float(((got.float() - ref.float()).abs()
                                - 2 ** -7 * ref.float().abs()).max())
                self.check(ok, f"{name} {what}: max|d|={err:.3g}, max|ref|="
                               f"{top:.3g}, excess over 2^-7|ref| "
                               f"{excess:.3g} (tol "
                               f"{'2^-8 max|ref|' if bf16 else '1e-4'}"
                               f"+2^-7|ref|: excess <= {atol:.3g})")
                key = "dq" if name == "dq" else "dkv"
                worst[key] = max(worst[key], err)
                del ref
            torch.cuda.empty_cache()

        def budget(rows, T, H, KVH, seed, what):
            """bf16, on inputs of ``flash_bwd_reference.budget_case`` (q
            scaled so that the attention is peaked): the kernels' RMS error
            against a float64 backward at most BUDGET times the plain
            backward's (p and ds in fp32, rounded to bf16 at the end)."""
            g = torch.Generator(device=dev).manual_seed(seed)
            q, do = (torch.randn((rows, T, H, 128), generator=g, device=dev)
                     .to(torch.bfloat16) for _ in range(2))
            k, v = (torch.randn((rows, T, KVH, 128), generator=g, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
            mask = torch.ones((rows, T), dtype=torch.int32, device=dev)
            mask[-1, T // 3] = 0
            args = ref.budget_case(q, k, v, mask, do)
            got = (fa.flash_dq(*args), *fa.flash_dkv(*args))
            for name, err, err_plain in ref.budget(got, *args):
                self.check(err <= ref.BUDGET * err_plain,
                           f"{name} {what} against float64: kernel RMS error "
                           f"{err:.4g}, plain backward {err_plain:.4g} (ratio "
                           f"{err / err_plain:.3f}, tol {ref.BUDGET:g})")
            del got, args
            torch.cuda.empty_cache()

        def timed(args, iters):
            """(kernel ms, plain ms, SDPA forward ms, SDPA backward ms): the
            forward, dQ and dK/dV kernels; their plain versions; and one
            ``torch.autograd.grad`` of ``scaled_dot_product_attention``
            (dq, dk and dv in one call; GQA heads repeated beforehand)."""
            q, k, v, mask, do = args[:5]
            ms = {"fwd": cuda_ms(lambda: fa.flash_attention(
                      q, k, v, mask, return_stats=True), iters),
                  "dq": cuda_ms(lambda: fa.flash_dq(*args), iters),
                  "dkv": cuda_ms(lambda: fa.flash_dkv(*args), iters)}
            plain = {"dq": cuda_ms(lambda: fa.flash_dq_plain(*args), 2, 1),
                     "dkv": cuda_ms(lambda: fa.flash_dkv_plain(*args), 2, 1)}
            torch.cuda.empty_cache()
            T, H = q.shape[1], q.shape[2]
            qt, kt, vt = (x.repeat_interleave(H // x.shape[2], dim=2)
                          .transpose(1, 2).detach().requires_grad_(True)
                          for x in (q, k, v))
            if bool((mask > 0).all()):
                kw = {"is_causal": True}
            else:
                kw = {"attn_mask": (mask[:, None, None, :] > 0) & torch.ones(
                    (T, T), dtype=torch.bool, device=dev).tril()[None, None]}
            fwd_ms = cuda_ms(lambda: sdpa(qt, kt, vt, **kw), iters)
            o = sdpa(qt, kt, vt, **kw)
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters)
            del o, qt, kt, vt
            torch.cuda.empty_cache()
            return ms, plain, fwd_ms, bwd_ms

        # a small ragged case: T not a multiple of 64, a masked key, GQA 4/2
        ragged = {}
        for dtype in (torch.bfloat16, torch.float32):
            what = f"{str(dtype)[6:]} rows=3 T=200 H=4/KVH=2, one masked key"
            ragged[dtype] = case(3, 200, 4, 2, dtype, True, 6, what)
            check(ragged[dtype], what)
        budget(3, 200, 4, 2, 8, "bf16 rows=3 T=200 H=4/KVH=2")
        ms, plain, fwd_ms, bwd_ms = timed(ragged[torch.bfloat16], 20)
        print(f"flash ragged case (bf16 rows=3 T=S=200 H=4/KVH=2, one masked "
              f"key): forward {ms['fwd']:.4f} ms (sdpa {fwd_ms:.4f}); dq "
              f"{ms['dq']:.4f} ms, plain {plain['dq']:.4f} ms; dkv "
              f"{ms['dkv']:.4f} ms, plain {plain['dkv']:.4f} ms; sdpa "
              f"backward (dq, dk, dv in one call) {bwd_ms:.4f} ms")
        # and against a reference independent of the plain versions' formulas:
        # torch autograd through the plain masked attention (fp32)
        from ospo_tpu_torch.ops.attention import attention

        q, k, v, mask, do = ragged.pop(torch.float32)[:5]
        grads = []
        for impl in ("flash", "xla"):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            grads.append(torch.autograd.grad(
                attention(*leaves, mask=mask, impl=impl), leaves, do))
        err = max(max_err(a, b) for a, b in zip(*grads))
        self.check(err < 1e-4, f"flash autograd (kernels) vs autograd of "
                               f"xla_attention, fp32 rows=3 T=200 GQA 4/2: "
                               f"max|d|={err:.3g} (tol 1e-4)")
        del ragged, grads, q, k, v, mask, do
        # the training shape: 16 pairs, the run's text bucket + 576 image
        # tokens, all-ones mask (the trainer's)
        rows, H, D = 32, 32, 128
        T = self.text_bucket + 576
        what = f"bf16 rows={rows} T=S={T} H={H} causal (training shape)"
        args = case(rows, T, H, H, torch.bfloat16, False, 7, what)
        check(args, what)
        # the float64 yardstick at 2 rows (all 32 heads: ~250 MB a score
        # tensor)
        budget(2, T, H, H, 9, f"bf16 rows=2 T=S={T} H={H}")
        ms, plain, sdpa_fwd_ms, lib_bwd_ms = timed(args, 10)
        pairs = rows * H * T * (T + 1) / 2
        tensor = rows * T * H * D * 2                     # one bf16 [B,T,H,D]
        stats = 3 * rows * H * T * 4 + rows * T * 4       # m, l, di, mask
        work = {"fwd": (4 * D * pairs, 4 * tensor + 2 * rows * H * T * 4
                        + rows * T * 4),
                "dq": (6 * D * pairs, 5 * tensor + stats),
                "dkv": (8 * D * pairs, 6 * tensor + stats)}
        bound = {}
        for name, (flops, nbytes) in work.items():
            bound[name] = (max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3,
                           "operations" if flops / PEAK_BF16 > nbytes / PEAK_BYTES
                           else "bytes")
            print(f"flash {name} at the training shape (rows={rows} T=S={T} "
                  f"H={H} bf16 causal): kernel {ms[name]:.4f} ms, bound "
                  f"{bound[name][0]:.5f} ms ({bound[name][1]}; "
                  f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)"
                  + (f", plain {plain[name]:.4f} ms" if name in plain else
                     f", sdpa forward {sdpa_fwd_ms:.4f} ms"))
        print(f"sdpa backward (dq, dk, dv in one call) at the training shape: "
              f"{lib_bwd_ms:.4f} ms")
        self.train_kernel_ms = ms
        if "flash_fwd" in self.kernels:
            entry = self.kernels["flash_fwd"]
            entry["max_abs_err"] = max(entry["max_abs_err"], worst["fwd"])
        for name, src, line in (("dq", "flash_bwd_dq", 137),
                                ("dkv", "flash_bwd_dkv", 181)):
            self.kernels[src] = {
                "name": src, "route": "cuda",
                "source": f"ospo_tpu_torch/ops/csrc/{src}.cu",
                "replaces": f"ospo_tpu/ops/flash_attention.py:{line}",
                "launches": None, "max_abs_err": worst[name],
                "ms": ms[name], "plain_ms": plain[name],
                "bound_ms": bound[name][0], "bound_by": bound[name][1],
                "library_ms": lib_bwd_ms,
                "library_note": "one torch.autograd.grad of "
                                "scaled_dot_product_attention computing dq, "
                                "dk and dv together; the same figure stands "
                                "in flash_bwd_dq and flash_bwd_dkv",
            }
        del args
        torch.cuda.empty_cache()

    def int4_kernels(self):
        """The int4 row and group decode matmuls against their plain version
        at the 7B projection shapes (M = 48 rows: 24 CFG pairs), a ragged
        case and fp32 x; timed at each 7B shape beside the cuBLAS bf16
        product on the weight pre-dequantized to bf16 (a yardstick that
        reads 4x the weight bytes: no PyTorch call takes this packing)."""
        from ospo_tpu_torch.ops import int4_matmul as i4
        from ospo_tpu_torch.ops import quant

        dev = torch.device("cuda")
        M = 48
        shapes = {"wq/wk/wv/wo": (4096, 4096), "w_gate/w_up": (11008, 4096),
                  "w_down": (4096, 11008)}
        per_layer = {"wq/wk/wv/wo": 4, "w_gate/w_up": 2, "w_down": 1}
        dequant = {"int4": quant.dequantize_matrix_int4,
                   "int4g": quant.dequantize_matrix_int4_group}

        def close(got, ref, mode, dtype):
            """bf16: one rounding step (2^-7 |ref|; 2^-6 for the row form,
            rounded before and after its scale) + 1e-3 max|ref|; fp32: 1e-5
            (|ref| and max|ref|).  The products are exact in fp32 on both
            sides; only the order of the fp32 sums differs."""
            g, r = got.float(), ref.float()
            top = float(r.abs().max())
            if dtype == torch.float32:
                tol = 1e-5 * top + 1e-5 * r.abs()
            else:
                tol = 1e-3 * top + (2 ** -6 if mode == "int4" else 2 ** -7) * r.abs()
            return bool(((g - r).abs() <= tol).all()), max_err(g, r)

        for mode, kname, line in (("int4", "int4_matmul_row", 76),
                                  ("int4g", "int4_matmul_group", 87)):
            g = torch.Generator(device=dev).manual_seed(11)
            worst, timing, step_ms = 0.0, None, 0.0
            for label, (F, D) in shapes.items():
                w = (torch.randn((F, D), generator=g, device=dev) * 0.02
                     ).to(torch.bfloat16)
                qw = quant.quant_fn(mode)(w)
                del w
                x = torch.randn((M, 1, D), generator=g, device=dev).to(torch.bfloat16)
                got = i4.int4_matmul_decode(x, qw)
                ref = i4.int4_matmul_decode_plain(x, qw)
                ok, err = close(got, ref, mode, torch.bfloat16)
                worst = max(worst, err)
                self.check(ok, f"{kname} bf16 M={M} F={F} D={D}: max|d|={err:.3g}"
                               f" (tol {'2^-6' if mode == 'int4' else '2^-7'}"
                               f"|ref| + 1e-3 max|ref|)")
                ms = cuda_ms(lambda: i4.int4_matmul_decode(x, qw), 50)
                plain_ms = cuda_ms(lambda: i4.int4_matmul_decode_plain(x, qw), 3, 1)
                wb = dequant[mode](qw, torch.bfloat16)
                x2 = x[:, 0]
                lib_ms = cuda_ms(lambda: x2 @ wb.T, 50)
                del wb
                scale_bytes = sum(t.numel() * 4 for k, t in qw.items() if k != "q4")
                nbytes = F // 2 * D + scale_bytes + M * D * 2 + M * F * 2
                flops = 2.0 * M * F * D
                bound_ms = max(nbytes / PEAK_BYTES, flops / PEAK_BF16) * 1e3
                by = "bytes" if nbytes / PEAK_BYTES > flops / PEAK_BF16 else "operations"
                step_ms += 30 * per_layer[label] * ms
                print(f"{kname} {label} (M={M} F={F} D={D} bf16): kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, cuBLAS bf16 on "
                      f"the dequantized weight (reads 4x the weight bytes) "
                      f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({by}; "
                      f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP; "
                      f"{nbytes / ms / 1e6:.1f} GB/s)")
                if label == "w_gate/w_up":
                    timing = (ms, plain_ms, bound_ms, by, lib_ms)
                del qw, x, got, ref
            print(f"{kname}: the 7 projections x 30 layers of one 7B decode "
                  f"step at these times: {step_ms:.3f} ms")
            # ragged: F/2 no multiple of the 64-row tile, M = 2 and 40; fp32 x
            for m, F, D, dtype in ((2, 200, 4096, torch.bfloat16),
                                   (40, 1000, 4096, torch.bfloat16),
                                   (8, 4096, 4096, torch.float32)):
                w = torch.randn((F, D), generator=g, device=dev) * 0.02
                qw = quant.quant_fn(mode)(w.to(dtype))
                x = torch.randn((m, 1, D), generator=g, device=dev).to(dtype)
                ok, err = close(i4.int4_matmul_decode(x, qw),
                                i4.int4_matmul_decode_plain(x, qw), mode, dtype)
                worst = max(worst, err)
                tol = ("1e-5 (|ref| + max|ref|)" if dtype == torch.float32 else
                       f"{'2^-6' if mode == 'int4' else '2^-7'}|ref| + 1e-3 max|ref|")
                self.check(ok, f"{kname} {str(dtype)[6:]} M={m} F={F} D={D}: "
                               f"max|d|={err:.3g} (tol {tol})")
            torch.cuda.empty_cache()
            self.kernels[kname] = {
                "name": kname, "route": "cuda",
                "source": f"ospo_tpu_torch/ops/csrc/{kname}.cu",
                "replaces": f"ospo_tpu/ops/int4_matmul.py:{line}",
                "launches": None, "max_abs_err": worst, "ms": timing[0],
                "plain_ms": timing[1], "bound_ms": timing[2],
                "bound_by": timing[3], "library_ms": timing[4],
                "library_note": "cuBLAS bf16 x @ W^T on the weight "
                                "pre-dequantized to bf16, at the w_gate shape "
                                "(M=48 F=11008 D=4096): a yardstick that reads "
                                "4x the weight bytes; no PyTorch call takes "
                                "this packing",
            }

    # -- phase 3 ---------------------------------------------------------
    def small_model(self):
        import dataclasses

        from ospo_tpu_torch.engine.image_engine import ImageGenEngine
        from ospo_tpu_torch.models import janus, llama, vqgan
        from ospo_tpu_torch.processing import Processor, t2i_prompt
        from ospo_tpu_torch.tokenizer import ByteTokenizer

        cfg = dataclasses.replace(
            janus.tiny_janus_config(),
            language=llama.tiny_config(hidden_size=256, intermediate_size=512,
                                       num_heads=2))
        from ospo_tpu_torch.ops import int4_matmul as i4

        proc = Processor(ByteTokenizer(cfg.language.vocab_size))
        prompts = [t2i_prompt(proc, "A red cube on a blue sphere"),
                   t2i_prompt(proc, "Two cats")]
        forced = torch.randint(0, cfg.image_token_size, (2, cfg.num_gen_tokens),
                               generator=torch.Generator().manual_seed(0)).numpy()
        to_cuda = lambda t: t.to("cuda")  # noqa: E731
        # int8 weights, then int4g (the group kernel on the GPU side, its
        # plain version on the CPU side); int8 KV in both
        for mode in ("int8", "int4g"):
            cpu_model = janus.JanusModel.init(cfg, seed=0, quantize=mode,
                                              device="cpu")
            gpu_params = _tree_map(cpu_model.params, to_cuda)
            gpu_model = janus.JanusModel(cfg, gpu_params, torch.device("cuda"))
            outs = []
            n0 = i4.group_launches
            for model in (cpu_model, gpu_model):
                eng = ImageGenEngine(model, proc,
                                     image_token_num=cfg.num_gen_tokens,
                                     img_size=cfg.gen_image_size,
                                     patch_size=cfg.vq.downsample_factor,
                                     kv_quant="int8")
                outs.append(eng.forced_cfg_logits(prompts, forced))
            ref, got = outs
            err = float(abs(ref - got).max())
            scale = float(abs(ref).max())
            moved = i4.group_launches - n0
            want = 7 * cfg.language.num_layers * (cfg.num_gen_tokens - 1) \
                if mode == "int4g" else 0
            self.check(err <= 1e-2 * scale and moved == want,
                       f"forced CFG logits GPU vs CPU (small model, {mode} "
                       f"weights, int8 KV): max|d|={err:.3g}, max|ref|="
                       f"{scale:.3g} (tol 1e-2 max|ref|); int4 group kernel "
                       f"launches {moved} (expected {want})")
        ids = torch.as_tensor(forced[:, :cfg.num_gen_tokens])
        px_cpu = vqgan.decode_code(cpu_model.params["gen_vision_model"], cfg.vq, ids)
        px_gpu = vqgan.decode_code(gpu_params["gen_vision_model"], cfg.vq,
                                   ids.cuda()).cpu()
        err = max_err(px_cpu, px_gpu)
        self.check(err < 1e-4, f"VQ decode GPU (fp32, TF32 off) vs CPU: "
                               f"max|d|={err:.3g} (tol 1e-4)")

    def _small_train_setup(self, dtype):
        """The small model (2 layers, width 256, head dim 128) in ``dtype``
        on the CPU, its processor, a LoRA (r8, dropout 0, flash path, remat)
        training config and one batch of 2 pairs (one text row padded)."""
        import dataclasses

        import numpy as np

        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.image_processing import ImageProcessor
        from ospo_tpu_torch.models import janus, llama
        from ospo_tpu_torch.processing import Processor
        from ospo_tpu_torch.tokenizer import ByteTokenizer

        cfg = dataclasses.replace(
            janus.tiny_janus_config(dtype=dtype),
            language=llama.tiny_config(hidden_size=256, intermediate_size=512,
                                       num_heads=2, dtype=dtype))
        cpu_model = janus.JanusModel.init(cfg, seed=1, device="cpu")
        proc = Processor(ByteTokenizer(cfg.language.vocab_size),
                         ImageProcessor(image_size=cfg.image_size))
        config = Config.from_nested({
            "base": {"save_path": os.path.join(self.workdir, "small")},
            "lora": {"lora_rank": 8, "lora_alpha": 16, "lora_dropout": 0.0},
            "experiment": {"seed": 0, "attn_impl": "flash",
                           "gradient_checkpointing": True},
            "algo": {"beta": 10, "gamma_beta_ratio": 0.5}})
        rng = np.random.default_rng(0)
        b, t = 2, 32
        mask = np.ones((b, t), np.float32)
        mask[1, 20:] = 0
        batch = (rng.integers(0, 256, (b, t)).astype(np.int32), mask,
                 rng.integers(0, 256, (b, 32, 32, 3)).astype(np.uint8),
                 rng.integers(0, 256, (b, 32, 32, 3)).astype(np.uint8))
        return cfg, cpu_model, proc, config, batch

    @staticmethod
    def _set_lora(trainers):
        """The same adapters on every trainer, B non-zero so A has a
        gradient too."""
        lora = {n: {"a": ab["a"], "b": torch.randn(
                    ab["b"].shape, generator=torch.Generator().manual_seed(2))
                    * 0.05} for n, ab in trainers[0].trainable.items()}
        for tr in trainers:
            tr._set_trainable(lora)

    def small_train_step(self):
        from ospo_tpu_torch.models import janus, vqgan
        from ospo_tpu_torch.ops import flash_attention as fa
        from ospo_tpu_torch.ops.pixels import normalize_pixels
        from ospo_tpu_torch.train.trainer import SimPOTrainer

        cfg, cpu_model, proc, config, batch = self._small_train_setup(
            torch.float32)
        gpu_model = janus.JanusModel(
            cfg, _tree_map(cpu_model.params, lambda t: t.to("cuda")),
            torch.device("cuda"))
        trainers = [SimPOTrainer(config, m, proc) for m in (cpu_model, gpu_model)]
        self._set_lora(trainers)
        n0 = (fa.launches, fa.dq_launches, fa.dkv_launches)
        out = [tr.loss_and_grads(*batch) for tr in trainers]
        torch.cuda.synchronize()
        moved = (fa.launches - n0[0], fa.dq_launches - n0[1],
                 fa.dkv_launches - n0[2])
        self.check(moved == (4, 2, 2), f"small training step on the GPU "
                   f"launched flash fwd/dq/dkv {moved} (2 layers, remat: "
                   f"(4, 2, 2))")
        ids = [vqgan.encode_to_ids(
            m.params["gen_vision_model"], cfg.vq,
            normalize_pixels(torch.as_tensor(batch[2]).to(m.device),
                             proc.image_processor)).cpu()
            for m in (cpu_model, gpu_model)]
        self.check(bool((ids[0] == ids[1]).all()),
                   "VQ encode ids GPU (fp32, TF32 off) vs CPU equal")
        (_, mc, gc), (_, mg, gg) = out
        lc, lg = float(mc["loss"]), float(mg["loss"])
        self.check(abs(lc - lg) <= 1e-4 * max(1.0, abs(lc)),
                   f"SimPO loss GPU vs CPU (small model, flash path, fp32): "
                   f"{lg:.6f} vs {lc:.6f} (tol 1e-4)")
        worst = 0.0
        for n in gc:
            for key in ("a", "b"):
                ref, got = gc[n][key], gg[n][key].cpu()
                scale = float(ref.abs().max())
                err = max_err(got, ref)
                worst = max(worst, err / max(scale, 1e-30))
        self.check(worst <= 1e-3, f"LoRA gradients GPU vs CPU: worst "
                                  f"max|d|/max|ref| over 14 leaves "
                                  f"{worst:.3g} (tol 1e-3)")

    def small_train_step_bf16(self):
        """The small model in bf16, one SimPO step on the GPU twice: through
        the dQ and dK/dV kernels' tensor-core bodies, and with ``fa.flash_dq``
        and ``fa.flash_dkv`` swapped (here only) for their plain versions,
        which the autograd Function looks up at call time.  The forward is
        the same, so the losses agree; the LoRA gradients differ only by
        the backward kernels' sums (cuBLAS-vs-CPU bf16 rounding is out of
        the comparison)."""
        from ospo_tpu_torch.models import janus
        from ospo_tpu_torch.ops import flash_attention as fa
        from ospo_tpu_torch.train.trainer import SimPOTrainer

        cfg, cpu_model, proc, config, batch = self._small_train_setup(
            torch.bfloat16)
        model = janus.JanusModel(
            cfg, _tree_map(cpu_model.params, lambda t: t.to("cuda")),
            torch.device("cuda"))
        trainer = SimPOTrainer(config, model, proc)
        self._set_lora([trainer])
        outs, moved = [], []
        kernels = (fa.flash_dq, fa.flash_dkv)
        for plain in (False, True):
            n0 = (fa.launches, fa.dq_launches, fa.dkv_launches)
            if plain:
                fa.flash_dq, fa.flash_dkv = fa.flash_dq_plain, fa.flash_dkv_plain
            try:
                outs.append(trainer.loss_and_grads(*batch))
                torch.cuda.synchronize()
            finally:
                fa.flash_dq, fa.flash_dkv = kernels
            moved.append((fa.launches - n0[0], fa.dq_launches - n0[1],
                          fa.dkv_launches - n0[2]))
        self.check(moved == [(4, 2, 2), (4, 0, 0)],
                   f"small bf16 training step launched flash fwd/dq/dkv "
                   f"{moved[0]} through the kernels (expected (4, 2, 2)), "
                   f"{moved[1]} with the plain backward (expected (4, 0, 0))")
        (lk, _, gk), (lp, _, gp) = outs
        lk, lp = float(lk), float(lp)
        self.check(abs(lk - lp) <= 1e-6 * max(1.0, abs(lp)),
                   f"SimPO loss, bf16, kernels vs plain backward: {lk:.7f} vs "
                   f"{lp:.7f} (tol 1e-6 relative)")
        worst, n_leaves = 0.0, 0
        for n in gp:
            for key in ("a", "b"):
                ref, got = gp[n][key], gk[n][key]
                n_leaves += 1
                worst = max(worst, max_err(got, ref)
                            / max(float(ref.abs().max()), 1e-30))
        self.check(worst <= 2 ** -6 and n_leaves == 14,
                   f"LoRA gradients, bf16, kernels vs plain backward: worst "
                   f"max|d|/max|ref| over {n_leaves} leaves {worst:.3g} "
                   f"(tol 2^-6)")

    # -- phase 4 ---------------------------------------------------------
    def main_path(self):
        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.ops import decode_attention as da
        from ospo_tpu_torch.ops import flash_attention as fa
        from ospo_tpu_torch.pipeline import step3
        from ospo_tpu_torch.utils.png import read_png

        tmp = self.workdir  # the PNG tree stays for phase 5
        config = Config.from_nested({
            **STEP3_CONFIG, "model_path": None, "model_preset": "7b",
            "data_path": FIXTURE, "e_idx": N_ITEMS,
            "save_path": os.path.join(tmp, "step3")})
        from ospo_tpu_torch.ops import int4_matmul as i4

        torch.cuda.reset_peak_memory_stats()
        fa.launches = da.launches = i4.row_launches = i4.group_launches = 0
        t0 = time.time()
        stats = step3.main(config)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {"flash_fwd": fa.launches, "decode_attention": da.launches}
        self.check(i4.row_launches == i4.group_launches == 0,
                   "int8 weights launched no int4 kernel")
        print(f"main path step 3 launches: {counts}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"main path: {stats['groups']} groups, {stats['images']} "
              f"images, {stats['image_tokens']} image tokens in "
              f"{stats['seconds']:.1f} s of serving "
              f"({stats['image_tokens'] / stats['seconds']:.1f} img-tok/s); "
              f"step3.main {wall:.1f} s with the 7B init; peak memory "
              f"{peak_gb:.2f} GB")
        layers, n_img = 30, 576
        groups = stats["groups"]
        self.check(counts["flash_fwd"] == layers * groups,
                   f"flash_fwd launches {counts['flash_fwd']} == "
                   f"{layers} x {groups} groups")
        self.check(counts["decode_attention"] == layers * (n_img - 1) * groups,
                   f"decode_attention launches {counts['decode_attention']}"
                   f" == {layers} x {n_img - 1} x {groups} groups")
        for name, n in counts.items():
            self.launches[name] = self.launches.get(name, 0) + n

        data = read_json(FIXTURE)[:N_ITEMS]
        n_png = 0
        bad = []
        for sample in data:
            for ptype in ("base", "negative"):
                d = os.path.join(tmp, "step3", ptype, sample["category"],
                                 sample["item_id"])
                if read_json(os.path.join(d, "metadata.json")) != sample:
                    bad.append(f"{d}/metadata.json")
                for i in range(3):
                    img = read_png(os.path.join(d, f"{i:02d}.png"))
                    n_png += 1
                    if img.shape != (384, 384, 3) or img.dtype.name != "uint8" \
                            or int(img.max()) == int(img.min()):
                        bad.append(f"{d}/{i:02d}.png {img.shape}")
        self.check(not bad and n_png == 6 * N_ITEMS and groups == 6,
                   f"output tree: {n_png} PNGs (384x384x3 uint8, "
                   f"non-constant) + metadata.json; bad: {bad[:3]}")

    # -- phase 5 ---------------------------------------------------------
    def train_path(self):
        import gc

        import numpy as np

        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.ops import flash_attention as fa
        from ospo_tpu_torch.pipeline import step5

        gc.collect()  # the int8 step-3 model of phase 4 goes first
        torch.cuda.empty_cache()
        print(f"device memory before step 5: "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        image_root = os.path.join(self.workdir, "step3")
        records = train_records()
        self.check(len(records) == 21 and all(
            os.path.exists(os.path.join(image_root, *r[k].split("/")[-4:]))
            for r in records for k in ("chosen", "rejected")),
            f"{len(records)} train.json records with their step-3 PNGs "
            "(expected 21)")
        data_path = os.path.join(self.workdir, "step4", "train.json")
        os.makedirs(os.path.dirname(data_path), exist_ok=True)
        with open(data_path, "w") as f:
            json.dump(records, f)
        save_path = os.path.join(self.workdir, "step5")
        config = Config.from_nested(merged(STEP5_CONFIG, step5_overrides(
            data_path, image_root, save_path)))
        torch.cuda.reset_peak_memory_stats()
        fa.launches = fa.dq_launches = fa.dkv_launches = 0
        t0 = time.time()
        trainer = step5.main(config)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {"flash_fwd": fa.launches, "flash_bwd_dq": fa.dq_launches,
                  "flash_bwd_dkv": fa.dkv_launches}
        print(f"main path step 5 launches: {counts}")
        for name, n in counts.items():
            self.launches[name] = self.launches.get(name, 0) + n
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = trainer.update_seconds
        stats = trainer.stats
        print(f"step 5: {trainer.global_step} optimizer steps, text bucket "
              f"{trainer._t_pad} (sequence {trainer._t_pad + 576}), step "
              f"seconds {[round(x, 3) for x in steps]}, samples/s steady "
              f"{stats.get('samples_per_s_steady')}, wall "
              f"{stats.get('samples_per_s_wall')}; step5.main {wall:.1f} s "
              f"with the 7B init; peak memory {peak_gb:.2f} GB")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        print(f"step 5 card: {smi.stdout.strip()}")
        if steps and self.train_kernel_ms:
            ms = self.train_kernel_ms
            flash_s = (60 * ms["fwd"] + 30 * ms["dq"] + 30 * ms["dkv"]) / 1e3
            print(f"flash kernels at the 16-pair shape (phase 2 times x 60/30/30"
                  f" launches): {flash_s:.3f} s of the last step's "
                  f"{steps[-1]:.3f} s ({100 * flash_s / steps[-1]:.1f}%)")
        micro = trainer.global_step  # no accumulation in configs/step5.yaml
        want = {"flash_fwd": 60 * micro, "flash_bwd_dq": 30 * micro,
                "flash_bwd_dkv": 30 * micro}
        self.check(counts == want and micro == 3,
                   f"step 5 launches {counts} == 60/30/30 x {micro} micro-steps")
        loss = trainer.logged[0]["loss"] if trainer.logged else float("nan")
        leaves = [t for ab in trainer.trainable.values() for t in ab.values()]
        finite = all(bool(torch.isfinite(t).all()) for t in leaves)
        moved = all(bool(ab["b"].abs().max() > 0)
                    for ab in trainer.trainable.values())
        self.check(np.isfinite(loss) and finite and moved,
                   f"step 5: logged loss {loss:.4f} finite, adapters finite "
                   f"and B moved off zero")
        ck = os.path.join(trainer.log_dir, "step_000003")
        files = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
        meta = read_json(os.path.join(ck, "meta.json")) if files else {}
        tstats = os.path.join(trainer.log_dir, "train_stats.json")
        keys = set(read_json(tstats)) if os.path.exists(tstats) else set()
        self.check(files == ["lora.npz", "meta.json", "opt.npz"]
                   and meta.get("step") == 3 and meta.get("mode") == "lora"
                   and keys == {"first_update_s", "total_s", "samples",
                                "samples_per_s_wall", "samples_per_s_steady"},
                   f"step_000003/ {files}, meta step {meta.get('step')}, "
                   f"train_stats.json keys {sorted(keys)}")


    # -- phases 6 and 7 ----------------------------------------------------
    def int4_path(self, mode: str):
        """Step 3 at the 7B width and depth with ``quantize: mode`` (int4g:
        the group kernel; int4: the row kernel), everything else as
        ``configs/step3.yaml``, over one group of 24 CFG pairs (M = 48 in
        every decode projection): the first prompt of each of the first 24
        fixture items, their other prompts left empty (step 3 skips an empty
        prompt), so the tree holds 24 images."""
        import gc

        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.ops import decode_attention as da
        from ospo_tpu_torch.ops import flash_attention as fa
        from ospo_tpu_torch.ops import int4_matmul as i4
        from ospo_tpu_torch.pipeline import step3
        from ospo_tpu_torch.utils.png import read_png

        gc.collect()  # the previous phase's model goes first
        torch.cuda.empty_cache()
        print(f"device memory before step 3 ({mode}): "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        data = read_json(FIXTURE)[:N_ITEMS]
        for sample in data:
            sample["long_prompt"] = [sample["long_prompt"][0], "", ""]
            sample["negative_long_prompt"] = ["", "", ""]
        root = os.path.join(self.workdir, f"step3_{mode}")
        os.makedirs(root, exist_ok=True)
        data_path = os.path.join(root, "long_prompt.json")
        with open(data_path, "w") as f:
            json.dump(data, f)
        config = Config.from_nested({
            **STEP3_CONFIG, "model_path": None, "model_preset": "7b",
            "quantize": mode, "data_path": data_path, "e_idx": N_ITEMS,
            "save_path": os.path.join(root, "out")})
        torch.cuda.reset_peak_memory_stats()
        fa.launches = da.launches = i4.row_launches = i4.group_launches = 0
        t0 = time.time()
        stats = step3.main(config)
        torch.cuda.synchronize()
        wall = time.time() - t0
        kname = "int4_matmul_group" if mode == "int4g" else "int4_matmul_row"
        other = i4.row_launches if mode == "int4g" else i4.group_launches
        counts = {"flash_fwd": fa.launches, "decode_attention": da.launches,
                  kname: i4.group_launches if mode == "int4g" else i4.row_launches}
        print(f"step 3 {mode} launches: {counts}")
        for name, n in counts.items():
            self.launches[name] = self.launches.get(name, 0) + n
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        print(f"step 3 {mode}: {stats['groups']} group(s), {stats['images']} "
              f"images, {stats['image_tokens']} image tokens in "
              f"{stats['seconds']:.1f} s of serving "
              f"({stats['image_tokens'] / stats['seconds']:.1f} img-tok/s); "
              f"step3.main {wall:.1f} s with the 7B init; peak memory "
              f"{peak_gb:.2f} GB; card {smi}")
        layers, steps, groups = 30, 575, stats["groups"]
        self.check(groups == 1 and counts[kname] == 7 * layers * steps * groups
                   and other == 0,
                   f"{kname} launches {counts[kname]} == 7 x {layers} x {steps} "
                   f"x {groups} group(s) (expected 1), the other int4 kernel "
                   f"{other}")
        self.check(counts["flash_fwd"] == layers * groups
                   and counts["decode_attention"] == layers * steps * groups,
                   f"flash_fwd {counts['flash_fwd']} == {layers} x {groups}, "
                   f"decode_attention {counts['decode_attention']} == "
                   f"{layers} x {steps} x {groups}")
        bad, n_png = [], 0
        for sample in data:
            for ptype in ("base", "negative"):
                d = os.path.join(root, "out", ptype, sample["category"],
                                 sample["item_id"])
                if read_json(os.path.join(d, "metadata.json")) != sample:
                    bad.append(f"{d}/metadata.json")
            img = read_png(os.path.join(root, "out", "base", sample["category"],
                                        sample["item_id"], "00.png"))
            n_png += 1
            if img.shape != (384, 384, 3) or img.dtype.name != "uint8" \
                    or int(img.max()) == int(img.min()):
                bad.append(f"{sample['item_id']}/00.png {img.shape}")
        self.check(not bad and n_png == N_ITEMS and stats["images"] == N_ITEMS,
                   f"step 3 {mode} output tree: {n_png} PNGs (384x384x3 uint8, "
                   f"non-constant) + metadata.json; bad: {bad[:3]}")


def train_records():
    """The records of the step-4 fixture whose images phase 4 writes."""
    from ospo_tpu_torch.io import read_json

    items = {(d["category"], d["item_id"]) for d in read_json(FIXTURE)[:N_ITEMS]}
    return [r for r in read_json(TRAIN_FIXTURE)
            if (r["category"], r["item_id"]) in items]


def train_bucket() -> int:
    """Phase 5's run-level text bucket, as the trainer computes it."""
    from ospo_tpu_torch.processing import Processor, t2i_prompt
    from ospo_tpu_torch.tokenizer import load_tokenizer
    from ospo_tpu_torch.train.trainer import _bucket

    proc = Processor(load_tokenizer(None, vocab_size=102400))
    return _bucket(max(len(proc.tokenizer.encode(t2i_prompt(proc, r["prompt"])))
                       for r in train_records()))


def _dominant_last_key(q, kc, vc, ks, vs, layer, cur):
    """Make position ``cur - 1`` of ``layer`` take ~all of every row's
    softmax (k along q, score ~20 above the rest) with a constant V."""
    last = cur - 1
    qt = q[:, 0].float().permute(1, 0, 2)                  # [H, B, dh]
    if kc.dtype == torch.int8:
        kc[layer, last] = (qt * 40).round().clamp(-127, 127).to(torch.int8)
        vc[layer, last] = 127
        ks[layer, last] = 0.05
        vs[layer, last] = 0.05
    else:
        kc[layer, last] = (qt * 2).to(kc.dtype)
        vc[layer, last] = 3.0


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(v, fn) for v in tree]
    return fn(tree)


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--skip-main", action="store_true",
                        help="stop after phase 3 (kernel and small-model "
                             "checks only)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import ospo_tpu_torch  # noqa: F401
    except ImportError:
        traceback.print_exc()
        return 3
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        smoke = Smoke(workdir)
        smoke.phase("environment and kernel build", smoke.environment)
        if smoke.failures:
            return 1
        smoke.phase("flash_fwd kernel vs plain", smoke.flash_kernel)
        smoke.phase("flash dQ and dK/dV kernels vs plain",
                    smoke.flash_backward_kernels)
        smoke.phase("decode_attention kernel vs plain", smoke.decode_kernel)
        smoke.phase("int4 row and group decode-matmul kernels vs plain",
                    smoke.int4_kernels)
        smoke.phase("small model GPU vs CPU", smoke.small_model)
        smoke.phase("small model training step GPU vs CPU",
                    smoke.small_train_step)
        smoke.phase("small model bf16 training step, backward kernels vs "
                    "plain", smoke.small_train_step_bf16)
        if not args.skip_main:
            smoke.phase("main path: step 3 at 7B width", smoke.main_path)
            smoke.phase("main path: step 5 at 7B width", smoke.train_path)
            smoke.phase("main path: step 3 at 7B width, quantize int4g",
                        lambda: smoke.int4_path("int4g"))
            smoke.phase("main path: step 3 at 7B width, quantize int4",
                        lambda: smoke.int4_path("int4"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if smoke.failures or args.skip_main:
        print(f"FAILED: {smoke.failures}")
        return 1
    for name, entry in smoke.kernels.items():
        entry["launches"] = smoke.launches.get(name, 0)
    print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
