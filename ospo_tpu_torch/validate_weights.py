"""The weights gate of the port — counterpart of
``scripts/validate_weights.py``, with its flags and its
``validation_report.json`` keys.

Given a Janus-Pro checkpoint directory (HF layout: ``config.json`` +
safetensors; the release, or a synthetic directory from
``models/synthetic.write_synthetic_checkpoint``) or a random-init preset:

1. ``port``       — per module: tensor count, GB (int4 at half a byte, as
                    packed), finiteness, degeneracy;
2. ``modules``    — every pathway on numpy-seeded inputs: ViT embeddings,
                    the VQ round trip (codebook usage), the trunk with both
                    heads;
3. ``divergence`` — teacher-forced CFG decode divergence on one shared
                    token sequence (per-step KL and top-1 agreement, by
                    quarter): the int8 and int4 KV caches against bf16,
                    ``--weight-divergence`` int8 / w8a8 / int4 / int4g
                    weights against the loaded ones, and the two-process
                    form ``--export-reference`` / ``--compare-reference``;
4. ``scoring``    — step 4b's yes/no readouts and pair choices, quantized
                    against bf16 (two-process);
5. ``samples``    — three images from fixed prompts, written as PNGs, with
                    their self-VQA scores.

A reference exported by either package can be compared by the other: the
files (``forced.npy``, ``ref_logits.npy``, ``meta.json``,
``scoring_ref.npz``) and the weight fingerprint are the same.  Images
travel as uint8 arrays (no Pillow); PNGs go through ``utils/png``.

    python -m ospo_tpu_torch.validate_weights --model_path DIR \\
        [--out ./validation] [--phases port,modules,divergence,samples]
        [--tokens 576] [--batch 2] [--quantize int8|w8a8|int4|int4g|none]
        [--weight-divergence] [--export-reference DIR]
        [--compare-reference DIR] [--drop-lm-head] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

PROMPTS = ["A red cube on a blue sphere",
           "Two cats sitting on a wooden bench",
           "A green apple next to a yellow banana"]


def _leaves(tree):
    """Tensors of a nested dict / list tree in ``jax.tree.leaves`` order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _std(t: torch.Tensor) -> float:
    return float(t.float().std(correction=0))


def _finite(*ts: torch.Tensor) -> bool:
    return all(bool(torch.isfinite(t.float()).all()) for t in ts)


def tree_stats(params) -> dict:
    out = {}
    for mod, sub in params.items():
        leaves = _leaves(sub)
        # int4 payloads are packed two a byte, so nbytes counts half a byte
        n_bytes = sum(x.numel() * x.element_size() for x in leaves)
        big = [x for x in leaves if x.numel() >= 1024]
        stds = [_std(x) for x in big[:8]]
        out[mod] = {
            "tensors": len(leaves),
            "gbytes": round(n_bytes / 1e9, 3),
            "finite": _finite(*leaves),
            "sample_stds": [round(s, 5) for s in stds],
            "degenerate": bool(big) and all(s == 0.0 for s in stds),
        }
    return out


def phase_port(model) -> dict:
    stats = tree_stats(model.params)
    ok = all(v["finite"] and not v["degenerate"] for v in stats.values())
    return {"ok": ok, "modules": stats}


@torch.inference_mode()
def phase_modules(model, processor) -> dict:
    """Every pathway on deterministic inputs (``np.random.RandomState(0)``,
    drawn in the JAX script's order)."""
    from ospo_tpu_torch.models import janus as janus_lib
    from ospo_tpu_torch.models import llama, vqgan

    cfg, params, dev = model.cfg, model.params, model.device
    rng = np.random.RandomState(0)
    report = {}

    side = cfg.vision.image_size
    pix = rng.rand(2, side, side, 3).astype(np.float32) * 2 - 1
    if "vision_model" in params:
        emb = janus_lib.encode_images(
            params, cfg, torch.as_tensor(pix, device=dev).to(cfg.dtype))
        report["vit_embeds"] = {"shape": list(emb.shape), "std": _std(emb),
                                "finite": _finite(emb)}

    gside = cfg.gen_image_size
    gpix = rng.rand(2, gside, gside, 3).astype(np.float32) * 2 - 1
    if "gen_vision_model" in params:
        vq = params["gen_vision_model"]
        codes = vqgan.encode_to_ids(vq, cfg.vq, torch.as_tensor(gpix, device=dev))
        latent = gside // cfg.vq.downsample_factor
        recon = vqgan.decode_code(vq, cfg.vq, codes, latent_hw=(latent, latent))
        report["vq_roundtrip"] = {
            "codes_shape": list(codes.shape),
            "distinct_codes": int(torch.unique(codes).numel()),
            "recon_std": _std(recon), "finite": _finite(recon)}

    ids = torch.as_tensor(rng.randint(0, cfg.language.vocab_size, (2, 16)),
                          device=dev)
    mask = torch.ones((2, 16), dtype=torch.int32, device=dev)
    hidden, _ = janus_lib.language_forward(
        params, cfg, janus_lib.embed_text(params, ids), mask,
        llama.positions_from_mask(mask))
    trunk = {}
    heads = []
    if "lm_head" in params["language_model"]:
        lm = janus_lib.lm_logits(params, hidden[:, -1:])
        trunk["lm_logits_std"] = _std(lm)
        heads.append(lm)
    if "gen_head" in params:
        gen = janus_lib.gen_logits(params, hidden[:, -1:])
        trunk["gen_logits_std"] = _std(gen)
        heads.append(gen)
    trunk["finite"] = _finite(hidden, *heads)
    report["trunk"] = trunk
    report["ok"] = all(v["finite"] for v in report.values()
                       if isinstance(v, dict))
    return report


def _divergence_metrics(ref, test) -> dict:
    """ref/test: [B, T, V] fp32 fused CFG logits on the same forced
    sequence → per-quarter KL(ref‖test) and top-1 agreement."""
    def logsoftmax(x):
        x = x - x.max(-1, keepdims=True)
        return x - np.log(np.exp(x).sum(-1, keepdims=True))

    lp, lq = logsoftmax(ref), logsoftmax(test)
    kl = (np.exp(lp) * (lp - lq)).sum(-1)                  # [B, T]
    agree = (ref.argmax(-1) == test.argmax(-1))            # [B, T]
    T = ref.shape[1]
    quarters = []
    for qi in range(4):
        sl = slice(qi * T // 4, (qi + 1) * T // 4)
        quarters.append({
            "kl_mean": float(kl[:, sl].mean()),
            "kl_p95": float(np.percentile(kl[:, sl], 95)),
            "top1_agree": float(agree[:, sl].mean()),
        })
    return {
        "kl_mean": float(kl.mean()),
        "kl_max": float(kl.max()),
        "top1_agree": float(agree.mean()),
        "by_quarter": quarters,
    }


def _weight_fingerprint(model) -> list:
    """Identity of the loaded weights, the JAX script's to the digit: the
    mean and std of three spread rows of ``language_model.embed`` (a leaf
    no weight quantization touches) and two values of row 0."""
    emb = model.params["language_model"]["embed"]
    v = int(emb.shape[0])
    flat = []
    for r in (1, v // 2, v - 1):
        row = emb[r].float().cpu().numpy()
        flat += [float(row.mean()), float(row.std())]
    flat += [float(x) for x in emb[0][:2].float().cpu().numpy()]
    return [round(x, 5) for x in flat]


def _engine(model, processor, kv_quant, batch: int, n_tokens: int):
    from ospo_tpu_torch.engine.image_engine import ImageGenEngine

    cfg = model.cfg
    return ImageGenEngine(
        model, processor, kv_quant=kv_quant,
        image_token_num=min(n_tokens, cfg.num_gen_tokens),
        img_size=cfg.gen_image_size, patch_size=cfg.vq.downsample_factor,
        kv_layout="shbd", decode_segments=8,
        batch_cap=batch)   # no batch bucketing, as the JAX script


def phase_divergence(model, processor, n_tokens: int, batch: int,
                     weight_divergence: bool,
                     export_reference: str = None,
                     compare_reference: str = None,
                     quantize_label: str = "int8") -> dict:
    """Teacher-forced serving-quantization divergence (the int4 gate), and
    its two-process form: ``--export-reference DIR`` saves the forced
    tokens and reference logits of this process's weights; a process with
    the serving quantization runs ``--compare-reference DIR`` against them
    (the fingerprint and the shapes must match)."""
    from ospo_tpu_torch.models import janus as janus_lib
    from ospo_tpu_torch.ops import quant
    from ospo_tpu_torch.processing import t2i_prompt

    cfg = model.cfg
    prompts = [t2i_prompt(processor, p) for p in
               PROMPTS[:2] * ((batch + 1) // 2)][:batch]

    report = {}
    if compare_reference:
        with open(os.path.join(compare_reference, "meta.json")) as f:
            meta = json.load(f)
        want_tokens = min(n_tokens, cfg.num_gen_tokens)
        if meta["batch"] != batch or meta["n_tokens"] != want_tokens:
            raise SystemExit(
                f"reference shape mismatch: {compare_reference} was "
                f"exported with batch={meta['batch']} "
                f"n_tokens={meta['n_tokens']}, this run uses "
                f"batch={batch} n_tokens={want_tokens} — re-export or "
                f"pass matching --batch/--tokens")
        fp = _weight_fingerprint(model)
        ref_fp = meta.get("weight_fingerprint")
        if ref_fp is not None and (len(ref_fp) != len(fp) or any(
                abs(a - b) > 1e-4 for a, b in zip(fp, ref_fp))):
            raise SystemExit(
                f"weight fingerprint mismatch: this process loaded "
                f"{fp} but the reference at {compare_reference} was "
                f"exported from {ref_fp} — different checkpoints")
        forced = np.load(os.path.join(compare_reference, "forced.npy"))
        ref_logits = np.load(os.path.join(compare_reference, "ref_logits.npy"))
        eng = _engine(model, processor, False, batch, n_tokens)
        key = f"w_{quantize_label}_vs_{meta['quantize']}"
        report[key] = _divergence_metrics(
            ref_logits, eng.forced_cfg_logits(prompts, forced))
        print(f"# weight divergence {key}: {report[key]['kl_mean']:.5f} mean "
              f"KL, {report[key]['top1_agree']:.3f} top-1", flush=True)
        report["n_tokens"] = int(forced.shape[1])
        report["batch"] = batch
        report["reference_meta"] = meta
        return report

    # the reference sequence and logits: the loaded weights, bf16 KV cache
    ref_engine = _engine(model, processor, False, batch, n_tokens)
    forced = ref_engine.generate_tokens(prompts, seed=0)
    ref_logits = ref_engine.forced_cfg_logits(prompts, forced)

    if export_reference:
        os.makedirs(export_reference, exist_ok=True)
        np.save(os.path.join(export_reference, "forced.npy"),
                np.asarray(forced))
        np.save(os.path.join(export_reference, "ref_logits.npy"),
                np.asarray(ref_logits, dtype=np.float32))
        with open(os.path.join(export_reference, "meta.json"), "w") as f:
            json.dump({"batch": batch, "n_tokens": int(forced.shape[1]),
                       "quantize": quantize_label,
                       "weight_fingerprint": _weight_fingerprint(model)}, f)
        print(f"# reference exported → {export_reference}", flush=True)
        report["exported"] = export_reference
        report["n_tokens"] = int(forced.shape[1])
        report["batch"] = batch
        return report

    for kv in ("int8", "int4"):
        eng = _engine(model, processor, kv, batch, n_tokens)
        key = f"kv_{kv}_vs_bf16"
        report[key] = _divergence_metrics(
            ref_logits, eng.forced_cfg_logits(prompts, forced))
        print(f"# divergence kv={kv}: {report[key]['kl_mean']:.5f} mean KL, "
              f"{report[key]['top1_agree']:.3f} top-1", flush=True)

    if weight_divergence:
        # the loaded (bf16) trunk against each quantized copy, both with a
        # bf16 cache: both trunks reside together
        lm = model.params["language_model"]
        if any(x.dtype == torch.int8 for x in _leaves(lm)):
            raise ValueError("--weight-divergence needs --quantize none "
                             "(the loaded trunk is already quantized)")
        for wmode in ("int8", "w8a8", "int4", "int4g"):
            layers = quant.quantize_layers(dict(lm["layers"]), wmode)
            qmodel = janus_lib.JanusModel(cfg, {
                **model.params, "language_model": {**lm, "layers": layers}},
                model.device)
            eng = _engine(qmodel, processor, False, batch, n_tokens)
            key = f"w_{wmode}_vs_bf16"
            report[key] = _divergence_metrics(
                ref_logits, eng.forced_cfg_logits(prompts, forced))
            print(f"# weight divergence {wmode}: "
                  f"{report[key]['kl_mean']:.5f} mean KL, "
                  f"{report[key]['top1_agree']:.3f} top-1", flush=True)
            del qmodel, layers, eng

    report["n_tokens"] = int(forced.shape[1])
    report["batch"] = batch
    return report


def phase_scoring(model, processor, export_reference: str = None,
                  compare_reference: str = None,
                  quantize_label: str = "int8", n_items: int = 4) -> dict:
    """The scoring gate: do the serving modes change step 4b's yes/no
    readouts and the pairs it selects?  Two-process, as the weight gate.  A
    quantized process scores one item (6 images) a call on the
    shared-prefix path with the int8 prefix cache; a bf16 one scores one
    image a call on the unshared path (``share_prefix=False``), as the JAX
    script does (``scripts/validate_weights.py:314-431``)."""
    from ospo_tpu_torch.engine.scoring import (ScoringEngine,
                                               compute_preference_strength)

    side = model.cfg.vision.image_size
    rng = np.random.default_rng(7)
    qsets = [
        ["Is there a black umbrella?", "Is the umbrella open?",
         "Does this image accurately represent the prompt?"],
        ["Is there a red car?", "Is it parked?", "Is it daytime?",
         "Does this image accurately represent the prompt?"],
        ["Is there a dog?",
         "Does this image accurately represent the prompt?"],
    ]
    items = []
    for it in range(n_items):
        imgs = [(rng.random((side, side, 3)) * 255).astype(np.uint8)
                for _ in range(6)]  # base_0..2 + negative_0..2
        items.append((imgs, qsets[it % len(qsets)]))

    # main() maps --quantize none → the label "bf16"
    quantized = quantize_label not in ("none", "", "bf16")
    engine = ScoringEngine(model, processor, kv_quant=quantized)
    scores = []
    if quantized:
        for imgs, qs in items:
            scores.extend(engine.score_images_multi(imgs, [qs] * len(imgs)))
    else:
        for imgs, qs in items:
            for im in imgs:
                scores.extend(engine.score_images_multi(
                    [im], [qs], share_prefix=False))

    p_yes, p_no, chosen = [], [], []
    for it in range(n_items):
        res = scores[it * 6:(it + 1) * 6]
        for r in res:
            for a in r["answer_metadata"]:
                p_yes.append(a["p_yes"])
                p_no.append(a["p_no"])
        base_d = {f"base_{i}": {**res[i], "path": f"b{it}_{i}"}
                  for i in range(3)}
        neg_d = {f"negative_{i}": {**res[3 + i], "path": f"n{it}_{i}"}
                 for i in range(3)}
        sel = compute_preference_strength(base_d, neg_d)
        chosen.append(-1 if sel is None else int(sel[0][1:].split("_")[1]))
    p_yes = np.asarray(p_yes, np.float32)
    p_no = np.asarray(p_no, np.float32)
    chosen = np.asarray(chosen, np.int32)

    report = {"n_items": n_items, "n_readouts": int(p_yes.size)}
    if export_reference:
        os.makedirs(export_reference, exist_ok=True)
        np.savez(os.path.join(export_reference, "scoring_ref.npz"),
                 p_yes=p_yes, p_no=p_no, chosen=chosen,
                 fingerprint=np.asarray(_weight_fingerprint(model),
                                        np.float64))
        print(f"# scoring reference exported → {export_reference}",
              flush=True)
        report["exported"] = export_reference
        return report
    if compare_reference:
        ref = np.load(os.path.join(compare_reference, "scoring_ref.npz"))
        fp = np.asarray(_weight_fingerprint(model), np.float64)
        if not np.allclose(ref["fingerprint"], fp, atol=1e-4):
            raise SystemExit(
                f"weight fingerprint mismatch: this process loaded "
                f"{fp.tolist()} but {compare_reference} was exported "
                f"from {ref['fingerprint'].tolist()}")
        d = np.abs(p_yes - ref["p_yes"])
        ans = np.sign(p_yes - p_no)
        ref_ans = np.sign(ref["p_yes"] - ref["p_no"])
        key = f"scoring_{quantize_label}_vs_bf16"
        report[key] = {
            "mean_abs_dp_yes": float(d.mean()),
            "max_abs_dp_yes": float(d.max()),
            "answer_agree": float((ans == ref_ans).mean()),
            "pair_agree": float((chosen == ref["chosen"]).mean()),
        }
        print(f"# {key}: mean|Δp_yes|={d.mean():.5f} "
              f"max={d.max():.5f} answers={report[key]['answer_agree']:.3f} "
              f"pairs={report[key]['pair_agree']:.3f}", flush=True)
    return report


def phase_samples(model, processor, out_dir: str, n_samples: int = 3) -> dict:
    from ospo_tpu_torch.engine.image_engine import ImageGenEngine
    from ospo_tpu_torch.engine.scoring import ScoringEngine
    from ospo_tpu_torch.utils.png import write_png

    cfg = model.cfg
    prompts = PROMPTS[:n_samples]
    engine = ImageGenEngine(
        model, processor, image_token_num=cfg.num_gen_tokens,
        img_size=cfg.gen_image_size, patch_size=cfg.vq.downsample_factor,
        kv_quant="int8", kv_layout="shbd", decode_segments=8)
    images = engine.generate_from_raw_prompts(prompts, seed=0)

    scorer = ScoringEngine(model, processor)
    report = {"samples": []}
    os.makedirs(out_dir, exist_ok=True)
    for i, (prompt, img) in enumerate(zip(prompts, images)):
        path = os.path.join(out_dir, f"sample_{i}.png")
        write_png(path, img)
        qs = [f"Does this image show: {prompt.lower()}?",
              f"This image is generated by a prompt: {prompt}. "
              "Does this image accurately represent the prompt?"]
        scores = scorer.score_images([img], qs)[0]
        report["samples"].append({
            "prompt": prompt, "path": path,
            "pixel_std": float(np.std(img.astype(np.float32))),
            "local_score": scores["local_score"],
            "global_score": scores["global_score"],
        })
    report["ok"] = all(s["pixel_std"] > 1.0 for s in report["samples"])
    return report


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_path", default=None)
    parser.add_argument("--model_preset", default=None,
                        help="random-init preset (tiny|1b|7b) instead of a "
                             "checkpoint")
    parser.add_argument("--out", default="./validation")
    parser.add_argument("--phases",
                        default="port,modules,divergence,samples")
    parser.add_argument("--tokens", type=int, default=576)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--quantize", default="int8",
                        help="serving weight quantization for divergence/"
                             "samples (int8 | w8a8 | int4 | int4g | none)")
    parser.add_argument("--weight-divergence", action="store_true",
                        help="also measure the quantized weight modes "
                             "against the loaded trunk (both trunks "
                             "resident; pass --quantize none)")
    parser.add_argument("--export-reference", default=None,
                        help="divergence / scoring: save the reference to "
                             "DIR and stop (pass --quantize none)")
    parser.add_argument("--compare-reference", default=None,
                        help="divergence / scoring: score this process's "
                             "weights against a reference exported by "
                             "--export-reference (of either package)")
    parser.add_argument("--drop-lm-head", action="store_true",
                        help="leave out the text head (divergence-only runs "
                             "use the image head alone)")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU (default: the GPU)")
    args = parser.parse_args(argv)

    from ospo_tpu_torch.config import Config
    from ospo_tpu_torch.pipeline.model_factory import get_model
    from ospo_tpu_torch.utils.profiling import print_process_summary

    t0 = time.time()
    phases = [p.strip() for p in args.phases.split(",") if p.strip()]
    known_phases = {"port", "modules", "divergence", "samples", "scoring"}
    unknown = [p for p in phases if p not in known_phases]
    if unknown:
        # a typo'd phase must not drop a gate quietly (a missing key reads
        # as passed)
        parser.error(f"unknown phase(s) {unknown}; "
                     f"valid: {sorted(known_phases)}")
    if not args.model_path and not args.model_preset:
        parser.error("one of --model_path / --model_preset is required")
    config = Config.from_nested({
        "model_path": args.model_path,
        "model_preset": args.model_preset,
        "quantize": args.quantize if args.quantize != "none" else None,
        "drop_lm_head": bool(args.drop_lm_head),
        "device": args.device,
    })
    model, _, processor = get_model(config)

    report = {"model_path": args.model_path or f"preset:{args.model_preset}",
              "phases": phases, "quantize": args.quantize}
    if "port" in phases:
        report["port"] = phase_port(model)
        print(f"# port: ok={report['port']['ok']}", flush=True)
    if "modules" in phases:
        report["modules"] = phase_modules(model, processor)
        print(f"# modules: ok={report['modules']['ok']}", flush=True)
    if "divergence" in phases:
        report["divergence"] = phase_divergence(
            model, processor, args.tokens, args.batch,
            args.weight_divergence,
            export_reference=args.export_reference,
            compare_reference=args.compare_reference,
            quantize_label=args.quantize)
    if "scoring" in phases:
        report["scoring"] = phase_scoring(
            model, processor,
            export_reference=args.export_reference,
            compare_reference=args.compare_reference,
            quantize_label=(args.quantize if args.quantize != "none"
                            else "bf16"))
    if "samples" in phases:
        report["samples"] = phase_samples(model, processor, args.out)
        print(f"# samples: ok={report['samples']['ok']}", flush=True)

    report["elapsed_s"] = round(time.time() - t0, 1)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "validation_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"# validation report → {path} ({report['elapsed_s']}s)")
    print_process_summary("validate_weights", {"phases": phases,
                                               "elapsed_s": report["elapsed_s"]})
    return report


if __name__ == "__main__":
    main()
