"""Drive the PyTorch/CUDA port (``ospo_tpu_torch``) on one GPU, end to end.

    python3 chip_smoke.py

Phases (the script exits non-zero, without its final result line, if any
fails):

1. environment: the card's name and power limit; build every CUDA kernel
   from ``ospo_tpu_torch/ops/csrc`` (one nvcc per source, in parallel);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with timings (kernel, plain version, one library call
   where one computes the same function) and the card's lower bound;
3. a small model (head dim 128) through the teacher-forced CFG probe on the
   GPU (kernels) and on the CPU (plain versions), same weights;
4. the main path: ``ospo_tpu_torch.pipeline.step3.main`` on the step-3
   serving configuration (``configs/step3.yaml``) at the full Janus-Pro-7B
   width (random int8 weights), 24 prompt items; every kernel's launch
   counter must move, and the PNG tree must hold real images.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "examples", "step2",
                       "long_prompt.json")
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
    def __init__(self):
        self.failures = []
        self.kernels = {}

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
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

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
        cpu_model = janus.JanusModel.init(cfg, seed=0, quantize="int8",
                                          device="cpu")
        to_cuda = lambda t: t.to("cuda")  # noqa: E731
        gpu_params = _tree_map(cpu_model.params, to_cuda)
        gpu_model = janus.JanusModel(cfg, gpu_params, torch.device("cuda"))
        proc = Processor(ByteTokenizer(cfg.language.vocab_size))
        prompts = [t2i_prompt(proc, "A red cube on a blue sphere"),
                   t2i_prompt(proc, "Two cats")]
        forced = torch.randint(0, cfg.image_token_size, (2, cfg.num_gen_tokens),
                               generator=torch.Generator().manual_seed(0)).numpy()
        outs = []
        for model in (cpu_model, gpu_model):
            eng = ImageGenEngine(model, proc, image_token_num=cfg.num_gen_tokens,
                                 img_size=cfg.gen_image_size,
                                 patch_size=cfg.vq.downsample_factor,
                                 kv_quant="int8")
            outs.append(eng.forced_cfg_logits(prompts, forced))
        ref, got = outs
        err = float(abs(ref - got).max())
        scale = float(abs(ref).max())
        self.check(err <= 1e-2 * scale,
                   f"forced CFG logits GPU vs CPU (small model, int8 weights "
                   f"and KV): max|d|={err:.3g}, max|ref|={scale:.3g} "
                   f"(tol 1e-2 max|ref|)")
        ids = torch.as_tensor(forced[:, :cfg.num_gen_tokens])
        px_cpu = vqgan.decode_code(cpu_model.params["gen_vision_model"], cfg.vq, ids)
        px_gpu = vqgan.decode_code(gpu_params["gen_vision_model"], cfg.vq,
                                   ids.cuda()).cpu()
        err = max_err(px_cpu, px_gpu)
        self.check(err < 1e-4, f"VQ decode GPU (fp32, TF32 off) vs CPU: "
                               f"max|d|={err:.3g} (tol 1e-4)")

    # -- phase 4 ---------------------------------------------------------
    def main_path(self):
        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.ops import decode_attention as da
        from ospo_tpu_torch.ops import flash_attention as fa
        from ospo_tpu_torch.pipeline import step3
        from ospo_tpu_torch.utils.png import read_png

        with tempfile.TemporaryDirectory() as tmp:
            config = Config.from_nested({
                **STEP3_CONFIG, "model_path": None, "model_preset": "7b",
                "data_path": FIXTURE, "e_idx": N_ITEMS,
                "save_path": os.path.join(tmp, "step3")})
            torch.cuda.reset_peak_memory_stats()
            fa.launches = da.launches = 0
            t0 = time.time()
            stats = step3.main(config)
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = {"flash_fwd": fa.launches, "decode_attention": da.launches}
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
                if name in self.kernels:
                    self.kernels[name]["launches"] = n

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
    smoke = Smoke()
    smoke.phase("environment and kernel build", smoke.environment)
    if smoke.failures:
        return 1
    smoke.phase("flash_fwd kernel vs plain", smoke.flash_kernel)
    smoke.phase("decode_attention kernel vs plain", smoke.decode_kernel)
    smoke.phase("small model GPU vs CPU", smoke.small_model)
    if not args.skip_main:
        smoke.phase("main path: step 3 at 7B width", smoke.main_path)
    if smoke.failures or args.skip_main:
        print(f"FAILED: {smoke.failures}")
        return 1
    print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
