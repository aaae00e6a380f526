"""Drive the PyTorch/CUDA port (``ospo_tpu_torch``) on one GPU, end to end.

    python3 chip_smoke.py

Phases (the script exits non-zero, without its final result line, if any
fails):

1. environment: the card's name and power limit; build every CUDA kernel
   from ``ospo_tpu_torch/ops/csrc`` (one nvcc per source, in parallel);
   fail on a ptxas register spill in any of them;
2. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with timings (kernel, plain version, one library call
   where one computes the same function, or for the int4 matmuls the
   cuBLAS bf16 product on the dequantized weight as a yardstick, both as
   device times from CUDA-graph replay with the weights cold in L2 and hot)
   and the card's lower bound; the bf16 flash kernels also against a float64
   forward and backward (RMS error at most twice the plain versions'), and
   a control build of the forward that rounds the scores to bf16 must fail
   that budget;
3. a small model (head dim 128) on the GPU (kernels) and on the CPU (plain
   versions), same weights: the teacher-forced CFG probe with int8 and
   with int4g weights, and one SimPO training step (loss and LoRA
   gradients); then the same model in bf16, one training step on the GPU
   through the backward kernels and once more with the plain backward;
4. the step-3 main path: ``ospo_tpu_torch.pipeline.step3.main`` on the
   serving configuration (``configs/step3.yaml``) at the full Janus-Pro-7B
   width (random int8 weights), 24 prompt items; its kernels' launch
   counters must move (the layer tail's three at 61, 30 and 30 launches a
   forward: the prefill and each of 575 steps a group), and the PNG tree
   must hold real images;
5. the step-5 main path: ``ospo_tpu_torch.pipeline.step5.main`` on
   ``configs/step5.yaml`` at the 7B width (random bf16 trunk) with
   ``attn_impl: flash``, 3 optimizer steps over the 21 records of
   ``tests/fixtures/examples/step4/train.json`` whose images phase 4 wrote;
   the flash forward, dQ and dK/dV counters must match 30 layers (the
   forward twice under remat) per micro-step, and the checkpoint must land;
6. step 3 as in phase 4 with ``quantize: int4g`` over one group of 24 CFG
   pairs (the first prompt of the first 24 items): the group kernel must
   launch 7 x 30 x 575 times, and the tree must hold 24 real images;
7. the same with ``quantize: int4`` and the row kernel;
8. the text main path: steps 1, 2 and 4a (``ospo_tpu_torch.pipeline.step1``,
   ``step2``, ``step4``, each ``main``) on their configs at the 7B width,
   one random int8 model shared by the three (``drop_vision``, ``lm_head``
   built): step 1 for one category (64 samples of one prompt, 256 new
   tokens), then ``combine_prompt`` over the fixture element files; step 2
   (2a and 2b, seeds 0, 1, 2) over the fixture's template-pure group of 10
   complex base prompts, ``max_new_tokens`` cut to ``STEP2_NEW_TOKENS``;
   step 4a over the 40 fixture long prompts, ``max_new_tokens`` cut to
   ``STEP4A_NEW_TOKENS``.  Per stage it prints tokens
   per second, batch, prefix and tail buckets, the mid-decode step time,
   peak memory and the flash and decode launches; every shared-prefix call
   must launch the flash forward 30 times (its B = 1 prefix prefill), and
   the JSON files must hold the reference's records;
9. the understanding path: step 4b (``ospo_tpu_torch.pipeline.step4.main``
   on ``configs/step4.yaml``, ``model_preset: 7b``: random int8 weights
   with SigLIP-L, the int8 prefix cache, 16 images a chunk) over phase 4's
   PNG tree, the fixture's questions of those 24 items
   (``tests/fixtures/examples/step4/vqa_prompt.json``, 144 images).  Every
   image must be scored with no out-of-memory retry, no unshared fallback
   and no per-image retry, the flash forward must launch 30 times per
   shared-program slice (its B = 1 pre-image prefill), and ``train.json``
   must hold the JAX package's record schema.  It prints images scored per
   second over the scoring loop (model set-up excluded), the slices and
   their (p_b, t_b, pre) buckets, the ViT, prefill and suffix device time
   per slice (CUDA events), and peak memory;
10. the inference CLI: ``ospo_tpu_torch.pipeline.inference.main`` on
    ``configs/inference.yaml`` composed by ``compose_config`` at the 7B
    width (int8 weights, int8 ``shbd`` KV, batch 24), seed 0, over the
    first 24 long prompts of the step-2 fixture, with phase 5's LoRA
    checkpoint as ``ckpt_path`` (merged, then quantized).  Every prompt
    must yield one real PNG under its own name or, for a name over 255
    bytes, ``longprompt_0_NNNN.png``, with no ``error_sample.json``; the
    flash forward must launch 30 times and decode attention 30 x 575; a
    second ``generate_all`` on the same tree and engine (its draws replaced
    by the first pass's images) must ask for the fallback prompts alone,
    none whose own names exist.  It prints img-tok/s over
    ``generate_all``, the merge and quantize seconds and peak memory;
11. full fine-tune: ``step5.main`` on ``configs/step5.yaml`` with
    ``use_peft: False`` (the yaml's freeze matrix: ``language_model``
    trains) at the Janus-Pro-1B width (bf16), ``attn_impl: flash``, 3
    optimizer steps over phase 5's records and images; the flash counters
    must match 24 layers (48/24/24 a micro-step), ``meta.json`` must say
    ``mode: full``, ``get_model`` with that checkpoint must give a
    language model bit-equal to the trained one, and the codebook must
    equal its initial value.  It first checks the temp directory's free
    space (``FULL_CKPT_GB``), and prints the step seconds, pairs/s, peak
    memory and the checkpoint's size and write seconds;
12. step 5 as in phase 5 with ``experiment.quantize_base: int8``: the
    trunk's seven projections must be int8, the flash counters 60/30/30 a
    micro-step, and the checkpoint must land; it prints the step seconds
    and peak memory beside phase 5's;
13. step 3's opt-in decode modes, each over one group of
    ``DECODE_MODE_ITEMS`` (12) CFG pairs (cut from 24 for time),
    as phases 6 and 7 otherwise (int8 weights): (a) ``kv_layout: bshd`` with the int8
    cache and ``decode_segments: 8``, the plain cache read; (b) the same
    with ``speculative: 4`` (speculative Jacobi decoding), printing
    ``last_sjd_iters`` and the tokens an iteration; (c) ``kv_quant: int4``
    at ``bshd``, printing its peak memory beside (a)'s.  Each must launch
    the flash forward 30 times and the decode kernel never; (a)'s model
    also runs the teacher-forced CFG probe (``PROBE_PROMPTS`` prompts,
    ``PROBE_TOKENS`` tokens) through a ``bshd`` engine and through the
    ``shbd`` engine of the decode kernel: on an fp32-activation model of
    the same width and depth the logits are within 1e-2 max|ref|; on (a)'s
    bf16 model the ``bshd`` read is within twice the distance of the
    kernel's own plain version (the control) from the kernel;
14. the weight modes: (a) ``quantize: int4n`` is no longer driven here
    (the port stores int4n as int4 rows, so it reran phase 7's path; cut
    for time); (b) step 4b as phase 9 with ``quantize: w8a8`` over the
    ``W8A8_SCORE_ITEMS`` first items (2 chunks), once with the w8a8 readout
    and once with ``readout_w8a16``: images/s for each and the share of
    yes/no answers on which the two agree; (c) step 5 as phase 12 with
    ``quantize_base: w8a8``, the step seconds and peak memory beside
    phase 12's;
15. a checkpoint directory and two processes, at the Janus-Pro-1B width:
    (a) ``ospo_tpu_torch.models.synthetic.write_synthetic_checkpoint``
    writes the 1B directory (seed ``SYNTH_SEED``) through the port's
    safetensors writer, with its seconds and GB, in a process of its own
    that starts before phase 11, so that its host draws run beside the
    card-bound phases 11 and 12; 15a waits for it; (b) ``get_model`` loads it
    on the card (seconds, peak memory) beside the preset's random init, a
    second ``load_janus`` must be bit-equal, four sampled tensors must
    equal the writer's values recomputed on the host, and the forced CFG
    probe must be finite; (c) ``scripts/run_multihost_torch.sh 2
    ospo_tpu_torch.pipeline.step3`` on ``configs/step3.yaml`` from the
    directory (int8 weights), ``DP_STEP3_ITEMS`` items with one prompt
    each (one group of 24 CFG pairs a rank, M = 48): both ranks on
    ``cuda:0`` with gloo, each image exactly once, each rank's flash and
    decode launches, img-tok/s a rank and for the pair; (d) ``step5`` (1B
    LoRA from the directory, ``attn_impl: flash``, no dropout, no gradient
    clip, global batch ``DP_STEP5_BATCH``, ``DP_STEP5_STEPS`` steps over
    that many of phase 4's records, one batch an epoch) in two ranks
    through the launcher against one rank on NCCL over the same
    micro-batches (batch 8, 2 accumulation steps): the first moments after
    step 1 (0.1 x the mean gradient) within 2^-16 max|ref| per tensor, the
    final adapters A and B within 2^-7 max|ref|, rank 0 alone writing
    checkpoints and scalars, and each run's mean seconds a step after the
    first;
16. tensor parallel at the Janus-Pro-1B width from that directory:
    ``scripts/run_multihost_torch.sh 2 chip_smoke --tp-worker DIR`` runs two
    ranks on the one card (gloo), ``tensor_parallel: 2``, each holding 8 of
    the 16 heads (:func:`tp_worker`): (a) step 3 on ``configs/step3.yaml``
    (int8 weights, int8 ``shbd`` KV) over ``TP_STEP3_ITEMS`` one-prompt
    items, one group of 12 CFG pairs: each image written once (by model
    rank 0) and real, each rank's flash and decode launches with a KV cache
    of 8 heads, img-tok/s a rank and for the pair; the forced CFG probe of
    the pair against this process's one-process kernel engine, within twice
    the distance of the kernel's plain version from the kernel (phase 13's
    bf16 control); (b) step 4b over phase 4's PNGs of the first
    ``TP_SCORE_ITEMS`` items (24 images): the yes/no answers equal one
    process's, with ``max|dp_yes|``; (c) greedy text ids (int8, the text
    steps' model) equal one process's;
17. the weights gate: ``python -m ospo_tpu_torch.validate_weights`` on the
    1B directory (``--phases port,modules,divergence,samples --quantize
    none --weight-divergence --tokens 576 --batch 2``), then its scoring
    reference exported in bf16 and compared in int8, in a process of their
    own started after phase 12 (when 15a's writer is done), beside phases
    13-16; the reports must be finite and carry the JAX script's keys, the
    three sample PNGs be real; it prints KL and top-1 agreement for the
    int8 and int4 KV caches and the int8, w8a8, int4 and int4g weights;
18. step 5 under tensor parallel at the Janus-Pro-1B width from phase 15's
    directory: ``scripts/run_multihost_torch.sh 2 chip_smoke
    --tp-train-worker DIR`` runs ``step5.main`` (:func:`tp_train_worker`)
    in two ranks on the one card (gloo), ``model.tensor_parallel: 2``, on
    ``configs/step5.yaml``'s trainer (LoRA r32 / alpha 64, remat, AdamW,
    clip 1.0) with ``attn_impl: flash``, no dropout, a global batch of
    ``TP_STEP5_BATCH`` pairs and ``TP_STEP5_STEPS`` steps, resumed from
    seeded adapters whose B is non-zero; this process runs ``step5.main``
    on the whole batch and, as the control, on two micro-batches of half
    the rows.  (a) Step 1's gradient of every adapter leaf, gathered, and
    (b) the steps' losses are within twice the control's distance from the
    one-process run; (c) the replicated leaves (column-parallel A,
    row-parallel B) and their moments are bit-equal on the two ranks; (d)
    the checkpoint, resumed in one process, equals the ranks' shards
    joined.  Each rank launches the flash forward, dQ and dK/dV at H = 8
    (48/24/24 a micro-batch); it prints the seconds a step, pairs/s and
    the group's collectives.

Phase 2 also holds the flash forward at the step-2 prefix prefill (B = 1,
H = 32, T = S = the prefix bucket, left-padded) and the decode kernel at
the text plain-path shape (int8 cache, B = 64, the step-1 prompt bucket +
256 rows), and the flash forward at step 4b's prefills (the B = 1
pre-image segment; the single-segment program's B = 8 slice, at its bucket
and at the 640-row remainder bucket); phase 3 also runs a small model's
text decode on the GPU and the CPU (greedy ids of the shared-prefix and
plain programs identical, first logits within 1e-2 max|ref|) and its step-4b
scoring (p_yes and p_no within 1e-3 relative, both programs, int8 and fp32
caches); phase 2 also holds the int4 row and group kernels at the 7B
trunk's tp = 2 shard shapes (``TP2_SHARD_SHAPES``), and the flash forward,
dQ and dK/dV at phase 18's shard (rows 8, H = 8); its 1B training shape
(rows 32, H = 16) is also the 7B trunk's tp = 2 shard.

19. step 3 on an MLA/MoE trunk: ``pipeline.step3.run_step3`` over one
    group of 24 CFG pairs (phase 6's prompts) through an ``ImageGenEngine``
    on a Janus model whose trunk is DeepSeek-V2-Lite at its full width and
    depth (``benchmark/configs/janus-deepseek-v2-lite.json``: 27 layers, 26
    of them MoE with 64 routed experts top-6 and 2 shared), random bf16
    weights made on the card by the benchmark's harness and handed to
    ``models/weights.load_janus`` from memory, quantized to int8; counted
    from a ``kernel_launches()`` read just before it, each of ``ops/moe.py``'s
    five kernels must launch 26 x 576 times (the prefill and 575 cached
    steps, replayed from the trunk graph), the group's ``image.experts``
    span must count 26 x 575 x 48 x 6 routed rows, and the tree must hold
    24 real images.
20. a step of a Qwen3-Next trunk at its full width and depth
    (``benchmark/configs/janus-qwen3-next-80b-a3b.json``: 48 layers, 36 of
    them Gated DeltaNet, every one MoE with 64 of 512 experts held, top-10,
    a gated shared expert), the harness's random weights quantized to int8:
    a prefill of 16 rows and one cached T = 1 step, eagerly; counted from a
    ``kernel_launches()`` read just before the step, ``gdn_decode`` must
    launch 36 times and each MoE kernel 48 times; and ``moe_route`` at 512
    experts top-10 over 192 tokens against ``route_plain`` (as phase 2's
    MoE check), its held range's ids and weights those of the same slots,
    the shared slots' weight the gate's sigmoid.
21. the Kimi Linear trunk at its full width and depth
    (``benchmark/configs/janus-kimi-linear-48b-a3b.json``: 27 layers, 20 of
    them Kimi Delta Attention, 7 NoPE MLA, 26 MoE with 64 of 256 sigmoid-
    routed experts held, top-8, a shared expert), the harness's random
    weights quantized to int8, through an ``ImageGenEngine`` whose trunk
    graph is captured and replayed: teacher-forced logits of 8 CFG pairs
    over 8 image tokens; counted from a ``kernel_launches()`` read just
    before the replayed call, ``kda_decode`` must launch 20 times a prompt
    position (the prefill runs the step once a position) and a step, and
    ``moe_route`` and ``moe_gate_up`` 26 times a pass; and ``moe_route``'s
    sigmoid mode at 256 experts top-8 with layer 1's correction bias against
    ``route_plain``.  ``--moe-only`` runs phase 1, phase 2's MoE, GDN and KDA
    checks and phases 19 to 21.

Phase 2 also holds ``ops/moe.py``'s kernels (``routed_experts`` on card
tensors) against the plain functions on the same tensors at
DeepSeek-V2-Lite's widths, a decode step's 48 tokens and a prefill
bucket's 48 x 64: the plain routing but at fp32 ties, the same weights
and counts, outputs within bf16 rounding, and two controls (a routed slot
dropped, one expert's down scales read from the next) outside that
tolerance.  It holds ``ops/gated_delta.py``'s ``gdn_decode`` against
``decode_plain`` at the Qwen3-Next cell's 192 rows (phase 2's GDN check:
the state within 1e-5, which a bf16 state fails) and times it against the
bytes' bound, and ``kda_decode`` against ``kda_decode_plain`` at the Kimi
Linear cell's 192 rows and 32 heads in the same way.  It holds ``ops/layer_tail.py``'s three kernels
(``add_rms_norm``, ``rope_kv_write``, ``silu_mul``) against their plain
forms at the 7B and 1B decode steps (48 rows, a device position, an int8
cache) and times each, and its plain chain, against the bytes' bound.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shlex
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import torch

from ospo_tpu_torch.utils.profiling import kernel_launches

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


# configs/step1.yaml, step2.yaml and step4.yaml as dicts (a CPU test holds
# them equal)
STEP1_CONFIG = {
    "seed": 42, "world_size": 1, "batch_size": 64, "num_workers": None,
    "save_path": "./outputs/step1", "ckpt_path": None,
    "model_path": "./checkpoints/Janus-Pro-7B", "model_preset": None,
    "cache_dir": "./checkpoints/hf_cache", "max_len": None, "category": None,
    "category_num": {"attribute1_color": 666, "attribute1_shape": 667,
                     "attribute1_texture": 667, "attribute2": 2000,
                     "layout1": 2000, "layout2": 1000, "layout3": 1000,
                     "non-spatial": 4000, "complex": 4000},
    "quantize": "int8", "kv_quant": "int8", "shared_prefix": True,
    "generation_config": {"do_sample": True, "temperature": 1.3,
                          "max_new_tokens": 256},
    "drop_vision": True,
}
STEP2_CONFIG = {
    "seed_list": [0, 1, 2], "world_size": None, "batch_size": 32,
    "num_workers": None, "data_path": None, "save_path": "./outputs/step2",
    "ckpt_path": None, "model_path": "./checkpoints/Janus-Pro-7B",
    "model_preset": None, "cache_dir": "./checkpoints/hf_cache",
    "quantize": "int8", "kv_quant": "int8", "shared_prefix": True,
    "generation_config": {"do_sample": True, "num_beams": 1,
                          "temperature": 1.2, "top_p": 0.5,
                          "max_new_tokens": 512},
    "drop_vision": True,
}
STEP4_CONFIG = {
    "seed": 42, "world_size": None, "batch_size": 64, "num_workers": None,
    "data_path": None, "image_path": "./outputs/step3",
    "save_path": "./outputs/step4", "ckpt_path": None,
    "model_path": "./checkpoints/Janus-Pro-7B", "model_preset": None,
    "cache_dir": "./checkpoints/hf_cache", "quantize": "int8",
    "score_rows": 16, "score_kv_quant": True, "score_failure_gate": True,
    "kv_quant": "int8", "shared_prefix": True,
    "generation_config": {"do_sample": True, "num_beams": 1,
                          "temperature": 0.8, "top_p": 0.9,
                          "max_new_tokens": 256},
}
VQA_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "examples", "step4",
                           "vqa_prompt.json")
# the keys of a train.json record and of its metadata (the JAX package's
# step4.run_scoring)
TRAIN_KEYS = {"item_id", "category", "sub_category", "question", "prompt",
              "chosen", "rejected", "metadata"}
TRAIN_META_KEYS = {"score_metadata", "base_meatadata", "negative_metadata"}
# phase 8's cut of step 2's new tokens (512 in configs/step2.yaml), so that
# its six calls fit the phase's time (PERF.md §4)
STEP2_NEW_TOKENS = 64
# and of step 4a's (256 in configs/step4.yaml), cut for time
STEP4A_NEW_TOKENS = 64
BASE_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "examples", "step1",
                            "base_prompt.json")


# phase 13's plain-read probe: prompts and image tokens (129, the fewest
# that keep two segments of growing windows; 192 before a cut for time);
# its groups' items (12 CFG pairs, cut from 24 for time)
DECODE_MODE_ITEMS = 12
PROBE_PROMPTS = 4
PROBE_TOKENS = 129
# phase 14b's items: 6 images each, 30 images = 2 chunks of 16
W8A8_SCORE_ITEMS = 5

# phase 11's 1B full checkpoint: the bf16 language model (lm_head included,
# ~1.65B parameters) and its fp32 first and second moments, with room
FULL_CKPT_GB = 20

# phase 15: the seed of the synthetic Janus-Pro-1B directory's values, the
# room it and its runs need (4.2 GB of shards), step 3's items (one a
# prompt of the first 16 fixture items: two ranks, one group of 24 CFG
# pairs each, as configs/step3.yaml's batch) and step 5's global batch (as
# configs/step5.yaml's) and steps, one global batch an epoch
SYNTH_SEED = 0
SYNTH_FREE_GB = 8
DP_STEP3_ITEMS = 48
DP_STEP5_BATCH = 16
DP_STEP5_STEPS = 3

# phase 16: tensor parallel, tp = 2, from phase 15's directory: step 3's
# items (one prompt each: one group of 12 CFG pairs, cut from the config's
# 24 for time), step 4b's items of phase 4's tree (6 PNGs each: 24 images,
# cut from 48 for time), the greedy text probe's prompts and new tokens
TP_STEP3_ITEMS = 12
TP_SCORE_ITEMS = 4
TP_TEXT_PROMPTS = 4
TP_TEXT_TOKENS = 32
# phase 2: the 7B trunk's int4 matrices as tp = 2 shards them (F x D): qkv
# and gate/up by rows, o and down by columns
TP2_SHARD_SHAPES = ((2048, 4096), (5504, 4096), (4096, 5504), (4096, 2048))
# phase 18: step 5 at tp = 2 from phase 15's directory: a global batch of 4
# pairs (the config's 16 would gather 1.48 GB of logits through the host a
# micro-batch), 3 steps, one batch an epoch; the seed of the starting
# adapters, whose B is drawn non-zero so that every A has a gradient
TP_STEP5_BATCH = 4
TP_STEP5_STEPS = 3
TP_STEP5_SEED = 7


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


# kernels whose ptxas report phase 1 reads: a register spill fails the run
SPILL_CHECKED = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "decode_attention", "int4_matmul_row", "int4_matmul_group",
                 "moe_experts", "w8a16_matmul", "suffix_attention", "gated_delta",
                 "layer_tail")

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


def cuda_ms_graph(fns, iters: int, replays: int = 5) -> float:
    """Mean device time of one call: ``iters`` calls cycling through ``fns``
    captured in one CUDA graph and replayed, so the host's cost of a launch
    (tens of microseconds of Python for a wrapper) stays out of the time.
    ``fns`` holding the same call on distinct copies of its data, together
    larger than the 50 MB L2, makes every call read its data from device
    memory, as a decode step does."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:          # first launches (set-up) outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def launched(before: dict, *names) -> dict:
    """Each kernel's launches (the kernels ``names``, else all) since
    ``before``, a ``kernel_launches()`` read."""
    now = kernel_launches()
    return {k: now[k] - before[k] for k in names or now}


def bf16_step(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |v| (fp32): 2^(floor(log2 |v|) - 7)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


class Smoke:
    def __init__(self, workdir: str):
        self.failures = []
        self.kernels = {}
        self.workdir = workdir          # phase 4 writes PNGs, phase 5 reads
        self.lora_train = {}            # phase 5's peak and step seconds
        self.text_bucket = train_bucket()
        self.launches = {}              # kernel → launches in the main paths
        self.trunks = {}                # phases 12, 14c: step seconds, peak
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
        import importlib.util

        print("safetensors package installed: "
              f"{importlib.util.find_spec('safetensors') is not None} (the port "
              "reads and writes the format itself)")
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
                        "loads" not in line and name in SPILL_CHECKED:
                    spills.append(f"{name}: {line.strip()}")
        reports = [n for n in SPILL_CHECKED if "spill" in logs.get(n, "")]
        self.check(len(reports) == len(SPILL_CHECKED) and not spills,
                   f"kernels build without register spills "
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
            else:
                # yardstick: SDPA over a contiguous copy of the populated
                # slice ([B, H, cur, dh]; the copy is not timed, and the
                # fully masked row comes out NaN there): the port never
                # calls it
                kt, vt = (x[15, :cur].permute(2, 1, 0, 3).contiguous()
                          for x in (kc, vc))
                qt, allowed = q.transpose(1, 2), mask[:, None, None, :cur] > 0
                sdpa_ms = cuda_ms(lambda: torch.nn.functional.
                                  scaled_dot_product_attention(
                                      qt, kt, vt, attn_mask=allowed), 50)
                print(f"decode_attention bf16 yardstick: SDPA over a "
                      f"contiguous copy of the cache slice, cur_len {cur}: "
                      f"{sdpa_ms:.4f} ms")
                bf16_timing = (ms, sdpa_ms)
                del kt, vt
            del kc, vc, ks, vs
            torch.cuda.empty_cache()
        self.kernels["decode_attention"] = {
            "name": "decode_attention", "route": "cuda",
            "source": "ospo_tpu_torch/ops/csrc/decode_attention.cu",
            "replaces": "ospo_tpu/ops/decode_attention.py:58",
            "launches": None, "max_abs_err": worst, "ms": timing[0],
            "plain_ms": timing[1], "bound_ms": timing[2],
            "bound_by": timing[3], "library_ms": None,
            "library_note": f"no PyTorch call takes the int8 cache with its "
                            f"scales; with a bf16 cache the kernel took "
                            f"{bf16_timing[0]:.4f} ms and SDPA over a "
                            f"contiguous copy of the slice (copy not timed) "
                            f"{bf16_timing[1]:.4f} ms at cur_len 672",
        }

    def flash_backward_kernels(self):
        from ospo_tpu_torch.ops import flash_attention as fa

        sys.path[:0] = [os.path.join(ROOT, "tests"), os.path.join(ROOT, "scripts")]
        import flash_bwd_reference as ref
        import flash_fwd_reference as fref
        from flash_bwd_budget_control import build_control, loaded

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

        control = build_control(["flash_fwd"])

        def fwd_budget(rows, T, H, KVH, seed, what):
            """bf16, on inputs of ``flash_fwd_reference.budget_case`` (q
            scaled so that the attention is peaked): the forward kernel's
            RMS error in O against a float64 forward at most BUDGET times
            the plain forward's (p in fp32, O rounded to bf16); the control
            build, which also rounds the scores q . k to bf16, must exceed
            it."""
            g = torch.Generator(device=dev).manual_seed(seed)
            q = torch.randn((rows, T, H, 128), generator=g, device=dev)
            k, v = (torch.randn((rows, T, KVH, 128), generator=g, device=dev)
                    for _ in range(2))
            mask = torch.ones((rows, T), dtype=torch.int32, device=dev)
            mask[-1, T // 3] = 0
            args = fref.budget_case(*(x.to(torch.bfloat16) for x in (q, k, v)),
                                    mask)
            for label, libs in (("kernel", {}), ("control", control)):
                with loaded(libs):
                    err, err_plain = fref.budget(fa.flash_attention(*args), *args)
                keeps = err <= fref.BUDGET * err_plain
                self.check(keeps == (label == "kernel"),
                           f"flash_fwd {what} against float64 ({label}"
                           f"{', scores rounded to bf16: must exceed' if label == 'control' else ''}"
                           f"): RMS error {err:.4g}, plain forward "
                           f"{err_plain:.4g} (ratio {err / err_plain:.3f}, "
                           f"tol {fref.BUDGET:g})")
            del args
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
        fwd_budget(3, 200, 4, 2, 8, "bf16 rows=3 T=200 H=4/KVH=2")
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
        fwd_budget(2, T, H, H, 9, f"bf16 rows=2 T=S={T} H={H}")
        # the 1B training shape (phase 11's full fine-tune): the same rows and
        # sequence, 16 heads; also the 7B trunk's tp = 2 shard (16 of its 32
        # heads)
        what_1b = (f"bf16 rows={rows} T=S={T} H=16 causal (1B training shape; "
                   "7B tp = 2 shard)")
        args_1b = case(rows, T, 16, 16, torch.bfloat16, False, 10, what_1b)
        check(args_1b, what_1b)
        budget(2, T, 16, 16, 11, f"bf16 rows=2 T=S={T} H=16 (1B)")
        fwd_budget(2, T, 16, 16, 11, f"bf16 rows=2 T=S={T} H=16 (1B)")
        q1, k1, v1, mask1 = args_1b[:4]
        print(f"flash at the 1B training shape ({what_1b}): forward "
              f"{cuda_ms(lambda: fa.flash_attention(q1, k1, v1, mask1, return_stats=True), 10):.4f}"
              f" ms, dq {cuda_ms(lambda: fa.flash_dq(*args_1b), 10):.4f} ms, "
              f"dkv {cuda_ms(lambda: fa.flash_dkv(*args_1b), 10):.4f} ms")
        del args_1b, q1, k1, v1, mask1
        # phase 18's shard: 4 pairs (8 rows) at tp = 2 of the 1B trunk, 8 of
        # its 16 heads, its 4 records' text bucket + 576 image tokens
        T18 = train_bucket(TP_STEP5_BATCH) + 576
        what_tp = f"bf16 rows=8 T=S={T18} H=8 causal (phase 18's tp = 2 shard)"
        args_tp = case(8, T18, 8, 8, torch.bfloat16, False, 12, what_tp)
        check(args_tp, what_tp)
        ms_tp, plain_tp, _, lib_tp = timed(args_tp, 20)
        print(f"flash at phase 18's shard ({what_tp}): forward "
              f"{ms_tp['fwd']:.4f} ms, dq {ms_tp['dq']:.4f} ms, dkv "
              f"{ms_tp['dkv']:.4f} ms; plain dq {plain_tp['dq']:.4f} ms, dkv "
              f"{plain_tp['dkv']:.4f} ms; sdpa backward {lib_tp:.4f} ms")
        del args_tp
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
                same = torch.equal(got, i4.int4_matmul_decode(x, qw))
                self.check(ok and same,
                           f"{kname} bf16 M={M} F={F} D={D}: max|d|={err:.3g}"
                           f" (tol {'2^-6' if mode == 'int4' else '2^-7'}"
                           f"|ref| + 1e-3 max|ref|); a second call bit-identical:"
                           f" {same}")
                plain_ms = cuda_ms(lambda: i4.int4_matmul_decode_plain(x, qw), 3, 1)
                wb = dequant[mode](qw, torch.bfloat16)
                x2 = x[:, 0]
                scale_bytes = sum(t.numel() * 4 for k, t in qw.items() if k != "q4")
                # hot: one weight, read from L2 after the first call; cold:
                # copies of the weight that together exceed the L2
                ms = cuda_ms_graph([lambda: i4.int4_matmul_decode(x, qw)], 50)
                lib_ms = cuda_ms_graph([lambda: x2 @ wb.T], 50)
                copies = -(-120_000_000 // (F // 2 * D + scale_bytes))
                qws = [{k: t.clone() for k, t in qw.items()}
                       for _ in range(copies)]
                cold_ms = cuda_ms_graph([lambda q=q: i4.int4_matmul_decode(x, q)
                                         for q in qws], 10 * copies)
                del qws
                wbs = [wb.clone() for _ in range(-(-120_000_000 // wb.nbytes))]
                lib_cold_ms = cuda_ms_graph([lambda w=w: x2 @ w.T for w in wbs],
                                            10 * len(wbs))
                del wb, wbs
                nbytes = F // 2 * D + scale_bytes + M * D * 2 + M * F * 2
                flops = 2.0 * M * F * D
                bound_ms = max(nbytes / PEAK_BYTES, flops / PEAK_BF16) * 1e3
                by = "bytes" if nbytes / PEAK_BYTES > flops / PEAK_BF16 else "operations"
                step_ms += 30 * per_layer[label] * cold_ms
                print(f"{kname} {label} (M={M} F={F} D={D} bf16): kernel "
                      f"{cold_ms:.4f} ms with the weight cold in L2 "
                      f"({100 * bound_ms / cold_ms:.1f}% of bound), "
                      f"{ms:.4f} ms on one weight hot in L2; plain "
                      f"{plain_ms:.4f} ms; cuBLAS bf16 on the dequantized "
                      f"weight (reads 4x the weight bytes) {lib_cold_ms:.4f} "
                      f"ms cold, {lib_ms:.4f} ms hot (device times from "
                      f"CUDA-graph replay); bound {bound_ms:.5f} ms ({by}; "
                      f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP; "
                      f"{nbytes / cold_ms / 1e6:.1f} GB/s cold)")
                print(f"{kname} {label}: kernel / cuBLAS yardstick "
                      f"{cold_ms / lib_cold_ms:.3f} cold, {ms / lib_ms:.3f} hot")
                if label == "w_gate/w_up":
                    timing = (cold_ms, plain_ms, bound_ms, by, lib_cold_ms)
                del qw, x, got, ref
            print(f"{kname}: the 7 projections x 30 layers of one 7B decode "
                  f"step at these (cold) times: {step_ms:.3f} ms")
            # ragged: F/2 no multiple of the 64-row tile, M = 2 and 40; fp32
            # x; the tp = 2 shards of phase 16's layout at M = 48
            for m, F, D, dtype in ((2, 200, 4096, torch.bfloat16),
                                   (40, 1000, 4096, torch.bfloat16),
                                   (8, 4096, 4096, torch.float32),
                                   *((M, F, D, torch.bfloat16)
                                     for F, D in TP2_SHARD_SHAPES)):
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
                                "this packing; ms and library_ms are device "
                                "times from CUDA-graph replay over copies of "
                                "the weight larger than the L2",
            }

    def w8a16_kernel(self):
        """The weight-only int8 T == 1 product (``quant.w8a16_matmul``)
        against the plain ``_w8a16`` on the card at 48 rows and the 7B and 1B
        projection shapes, as a step launches them: q, k and v in one launch,
        o, gate and up in one, down.  Tolerance one bf16 step of |ref| plus
        2^-8 max|ref| (both sides round the fp32 sum, then the scaled value;
        only the order of the fp32 sums differs); a second call bit-equal.
        Times: CUDA-graph replay over copies of the weights larger than the
        L2, beside the bytes bound, the plain version (copy + cuBLAS + scale)
        and cuBLAS on the weight dequantized to bf16 ahead of time."""
        from ospo_tpu_torch.ops import quant

        dev = torch.device("cuda")
        M = 48
        # (label, [F...] sharing x, D): one launch each, the 7B layer then 1B
        launches = (("7b wq/wk/wv", [4096] * 3, 4096), ("7b wo", [4096], 4096),
                    ("7b w_gate/w_up", [11008] * 2, 4096), ("7b w_down", [4096], 11008),
                    ("1b wq/wk/wv", [2048] * 3, 2048), ("1b wo", [2048], 2048),
                    ("1b w_gate/w_up", [5632] * 2, 2048), ("1b w_down", [2048], 5632))
        g = torch.Generator(device=dev).manual_seed(19)
        worst, layer_ms, rows = 0.0, {"7b": [0.0] * 4, "1b": [0.0] * 4}, {}
        prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        try:
            for label, fs, D in launches:
                qws = [quant.quantize_matrix(
                    (torch.randn((F, D), generator=g, device=dev) * 0.02).to(torch.bfloat16))
                    for F in fs]
                x = torch.randn((M, 1, D), generator=g, device=dev).to(torch.bfloat16)
                got = quant.w8a16_matmul(x, qws)
                ref = [quant._w8a16(x, w["q"], w["s"]) for w in qws]
                same = all(torch.equal(a, b) for a, b in zip(got, quant.w8a16_matmul(x, qws)))
                ok, err = True, 0.0
                for a, r in zip(got, ref):
                    rf = r.float()
                    tol = bf16_step(rf) + 2 ** -8 * float(rf.abs().max())
                    ok &= bool(((a.float() - rf).abs() <= tol).all())
                    err = max(err, max_err(a, r))
                worst = max(worst, err)
                self.check(ok and same, f"w8a16_matmul {label} M={M} F={fs} D={D}: "
                           f"max|d|={err:.3g} (tol one bf16 step of |ref| + 2^-8 "
                           f"max|ref|); a second call bit-identical: {same}")
                nbytes = sum(F * D + 4 * F + 2 * M * F for F in fs) + 2 * M * D
                flops = 2.0 * M * D * sum(fs)
                bound_ms = max(nbytes / PEAK_BYTES, flops / PEAK_BF16) * 1e3
                copies = -(-120_000_000 // nbytes)
                sets = [[{k: t.clone() for k, t in w.items()} for w in qws]
                        for _ in range(copies)]
                ms = cuda_ms_graph([lambda w=w: quant.w8a16_matmul(x, w) for w in sets],
                                   10 * copies)
                plain_ms = cuda_ms_graph(
                    [lambda w=w: [quant._w8a16(x, v["q"], v["s"]) for v in w]
                     for w in sets], 10 * copies)
                del sets
                wbs = [torch.cat([(w["q"].float() * w["s"][:, None]).to(torch.bfloat16)
                                  for w in qws])]
                wbs += [wbs[0].clone() for _ in range(-(-120_000_000 // wbs[0].nbytes) - 1)]
                x2 = x[:, 0]
                lib_ms = cuda_ms_graph([lambda w=w: x2 @ w.T for w in wbs], 10 * len(wbs))
                del wbs
                size, part = label.split(" ", 1)
                layer_ms[size][[t[0] for t in launches if t[0].startswith(size)]
                               .index(label)] = ms
                print(f"w8a16_matmul {label} (M={M} F={fs} D={D}): kernel {ms:.4f} ms "
                      f"cold in L2 ({100 * bound_ms / ms:.1f}% of bound, "
                      f"{nbytes / ms / 1e6:.1f} GB/s); plain (copy + cuBLAS + scale) "
                      f"{plain_ms:.4f} ms; cuBLAS bf16 on the weight dequantized "
                      f"ahead {lib_ms:.4f} ms; bound {bound_ms:.5f} ms "
                      f"({nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP)")
                rows[label] = (ms, plain_ms, bound_ms, lib_ms)
                del qws, x, got, ref
        finally:
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev
        for size, layers in (("7b", 30), ("1b", 24)):
            print(f"w8a16_matmul: one {size} decode step's projections at these "
                  f"times ({layers} layers x 4 launches): "
                  f"{layers * sum(layer_ms[size]):.3f} ms")
        torch.cuda.empty_cache()
        t = rows["7b w_gate/w_up"]
        self.kernels["w8a16_matmul"] = {
            "name": "w8a16_matmul", "route": "cuda",
            "source": "ospo_tpu_torch/ops/csrc/w8a16_matmul.cu",
            "replaces": None, "launches": None, "max_abs_err": worst,
            "ms": t[0], "plain_ms": t[1], "bound_ms": t[2], "bound_by": "bytes",
            "library_ms": t[3],
            "library_note": "cuBLAS bf16 x @ W^T on the two weights dequantized to "
                            "bf16 ahead of time (2x the int8 bytes), at the 7B "
                            "gate/up launch (M=48, F=2x11008, D=4096); device "
                            "times from CUDA-graph replay over copies larger than "
                            "the L2",
        }

    def suffix_kernel(self):
        """The suffix-attention kernel (``ops/suffix_attention.py``) at the
        1B cell's slice: 8 images, 16 heads, T = 240 suffix rows after 640
        image rows, a 48-row pre-image prefix (43 valid), int8 cache of 24
        layers; every row within ``tests/suffix_attention_reference.py``'s
        tolerance of the plain version, the three controls refused by 10x.
        Times: CUDA-graph replay cycling through the 24 layers (the window
        cold in L2, as a pass finds it), beside the bound (the int8 window,
        scales, prefix, q and out once; the valid prefix, image rows and
        the causal triangle's FLOPs), the plain version and SDPA over a
        dequantized bf16 copy with the prefix concatenated (copy not
        timed)."""
        from ospo_tpu_torch.ops import suffix_attention as sa

        sys.path[:0] = [os.path.join(ROOT, "tests")]
        import suffix_attention_reference as sref

        dev = torch.device("cuda")
        B, T, H, D, L0, C, pre_n, L = 8, 240, 16, 128, 640, 48, 43, 24
        a = sref.suffix_inputs(B, T, H, L0, C, "int8", seed=31, device=dev)
        a["prefix_mask"][:, :C - pre_n] = 0
        got = sref.call(sa.suffix_attention, a)
        ref, tol = sref.call(sref.plain_and_tolerance, a)
        worst = sref.worst(got, ref, tol)
        ctrl = {n: sref.worst(sref.call(sa.suffix_attention, a, **c), ref, tol)
                for n, c in sref.controls(a).items()}
        self.check(worst <= 1.0 and min(ctrl.values()) >= 10,
                   f"suffix_attention B={B} T={T} H={H} L0={L0} C={C} int8: "
                   f"max |d|/tol = {worst:.3g} (<= 1), controls {ctrl} (>= 10)")
        # the 24 layers of one cache: layer 1's rows in each
        caches = {n: a[n][1:2].expand(L, *a[n].shape[1:]).contiguous()
                  for n in ("k_cache", "v_cache", "k_scale", "v_scale")}
        b = {**a, **caches}
        ms = cuda_ms_graph([lambda li=li: sref.call(sa.suffix_attention, b, layer_idx=li)
                            for li in range(L)], 4 * L)
        plain_ms = cuda_ms(lambda: sref.call(sa.suffix_attention_plain, a), 5, 1)
        W = L0 + T
        kd = (a["k_cache"][1, :W].float() * a["k_scale"][1, :W, ..., None]
              ).permute(2, 1, 0, 3).to(torch.bfloat16)
        vd = (a["v_cache"][1, :W].float() * a["v_scale"][1, :W, ..., None]
              ).permute(2, 1, 0, 3).to(torch.bfloat16)
        kf = torch.cat([a["prefix_k"].permute(1, 0, 2)[None].expand(B, H, C, D), kd], 2)
        vf = torch.cat([a["prefix_v"].permute(1, 0, 2)[None].expand(B, H, C, D), vd], 2)
        rows = L0 + torch.arange(T, device=dev)[:, None]
        own = (a["mask"][:, None, None, :W] != 0) & (torch.arange(W, device=dev) <= rows)
        allowed = torch.cat([(a["prefix_mask"] != 0)[:, None, None, :].expand(B, 1, T, C),
                             own], -1)
        qt = a["q"].transpose(1, 2)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kf, vf, attn_mask=allowed), 20)
        flops = 4.0 * B * H * D * T * (pre_n + L0) + 4.0 * B * H * D * T * (T + 1) / 2
        nbytes = (2 * B * W * H * (D + 4) + 2 * C * H * D * 2 + 2 * B * T * H * D * 2
                  + B * W * 4)
        bound_ms = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
        print(f"suffix_attention B={B} T={T} H={H} L0={L0} C={C} int8: kernel "
              f"{ms:.4f} ms cold in L2 ({100 * bound_ms / ms:.1f}% of bound); plain "
              f"{plain_ms:.4f} ms; sdpa on a dequantized bf16 copy {lib_ms:.4f} ms; "
              f"bound {bound_ms:.5f} ms ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, "
              f"bound by {'operations' if flops / PEAK_BF16 > nbytes / PEAK_BYTES else 'bytes'})")
        self.kernels["suffix_attention"] = {
            "name": "suffix_attention", "route": "cuda",
            "source": "ospo_tpu_torch/ops/csrc/suffix_attention.cu",
            "replaces": None, "launches": None,
            "max_abs_err": max_err(got, ref), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flops / PEAK_BF16 > nbytes / PEAK_BYTES
            else "bytes",
            "library_ms": lib_ms,
            "library_note": "SDPA over the window dequantized to bf16 ahead of time "
                            "with the prefix concatenated and a boolean mask (copy "
                            "not timed); the kernel's time from CUDA-graph replay "
                            "cycling through 24 layers",
        }
        del a, b, caches, kd, vd, kf, vf, allowed
        torch.cuda.empty_cache()

    def layer_tail_kernels(self):
        """The layer tail's three kernels (``ops/layer_tail.py``) against
        their plain forms at the 7B and 1B decode steps (48 rows, T = 1, a
        device position, an int8 cache, q/k/v as views of one projection):
        the residual sum, rope, the cache rows and scales and SiLU·up
        bit-equal, the normed output within the tie of the normalised value
        (one bf16 step of x · rms, under two of the output) on at most 0.1%
        of its elements.  Times: CUDA-graph replay of each kernel and of its
        plain form (the op chain it replaced), inputs hot in L2 as the step
        leaves them, beside the bytes' bound (every byte once); and the
        tail of one step at these times."""
        from ospo_tpu_torch.models import llama
        from ospo_tpu_torch.ops import layer_tail

        dev = torch.device("cuda")
        M, S, at_len, iters = 48, 960, 672, 200
        rows = {}
        for size, (H, D, F, L) in (("7b", (32, 4096, 11008, 30)),
                                   ("1b", (16, 2048, 5632, 24))):
            g = torch.Generator(device=dev).manual_seed(D)
            x = (torch.randn((M, 1, D), generator=g, device=dev) * 3).bfloat16()
            y = torch.randn((M, 1, D), generator=g, device=dev).bfloat16()
            w = (1 + 0.3 * torch.randn(D, generator=g, device=dev)).bfloat16()
            qkv = (torch.randn((M, 1, 3 * D), generator=g, device=dev) * 2).bfloat16()
            q, k, v = (t.view(M, 1, H, 128) for t in qkv.split(D, dim=-1))
            gate, up = ((torch.randn((M, 1, F), generator=g, device=dev) * 4).bfloat16()
                        for _ in range(2))
            cfg = llama.LlamaConfig(hidden_size=D, num_heads=H, intermediate_size=F,
                                    num_layers=2)
            cos, sin = llama.rope_frequencies(
                cfg, torch.full((M, 1), at_len, device=dev))
            at = torch.tensor([at_len], device=dev)
            cache = llama.init_kv_cache(cfg, M, S, quantized="int8", device=dev)
            plain_cache = dict(cache, **{n: cache[n].clone() for n in ("k", "v", "k_s", "v_s")})

            gx, gh = layer_tail.add_rms_norm(x, y, w, 1e-6)
            px, ph = layer_tail.add_rms_norm_plain(x, y, w, 1e-6)
            # the sum of squares in another order: one bf16 step of x · rms,
            # which the weight's rounding carries to under two of the output
            differ = float((gh != ph).float().mean())
            step = bf16_step(torch.maximum(gh.float().abs(), ph.float().abs()))
            norm_ok = (torch.equal(gx, px) and differ <= 1e-3
                       and bool(((gh.float() - ph.float()).abs() <= 2 * step).all()))
            gq = layer_tail.rope_kv_write(q, k, v, cos, sin, cache, 1, at)[0]
            pq = layer_tail.rope_kv_write_plain(q, k, v, cos, sin, plain_cache, 1, at)[0]
            rope_ok = torch.equal(gq, pq) and all(
                torch.equal(cache[n], plain_cache[n]) for n in ("k", "v", "k_s", "v_s"))
            silu_ok = torch.equal(layer_tail.silu_mul(gate, up),
                                  layer_tail.silu_mul_plain(gate, up))
            self.check(norm_ok and rope_ok and silu_ok,
                       f"layer tail {size} M={M} D={D} H={H} F={F}: add_rms_norm's sum "
                       f"bit-equal and its output differing on {100 * differ:.4f}% of "
                       f"elements (<= 0.1%, each within two bf16 steps): {norm_ok}; "
                       f"rope_kv_write's q, int8 rows and scales bit-equal: {rope_ok}; "
                       f"silu_mul bit-equal: {silu_ok}")
            cases = {
                "add_rms_norm": (lambda: layer_tail.add_rms_norm(x, y, w, 1e-6),
                                 lambda: layer_tail.add_rms_norm_plain(x, y, w, 1e-6),
                                 8 * M * D + 2 * D),
                "rope_kv_write": (
                    lambda: layer_tail.rope_kv_write(q, k, v, cos, sin, cache, 1, at),
                    lambda: layer_tail.rope_kv_write_plain(q, k, v, cos, sin,
                                                           plain_cache, 1, at),
                    8 * M * H * 128 + 2 * M * 64 * 4 + 2 * M * H * (128 + 4)),
                "silu_mul": (lambda: layer_tail.silu_mul(gate, up),
                             lambda: layer_tail.silu_mul_plain(gate, up), 6 * M * F),
            }
            step_ms = {}
            for name, (kern, plain, nbytes) in cases.items():
                ms = cuda_ms_graph([kern], iters)
                plain_ms = cuda_ms_graph([plain], iters)
                bound_ms = nbytes / PEAK_BYTES * 1e3
                step_ms[name] = (ms, plain_ms)
                rows[(size, name)] = (ms, plain_ms, bound_ms)
                print(f"{name} {size} (M={M}): kernel {ms:.5f} ms hot in L2 "
                      f"({100 * bound_ms / ms:.1f}% of bound); plain chain "
                      f"{plain_ms:.5f} ms; bound {bound_ms:.6f} ms ({nbytes / 1e6:.3f} MB)")
            a, r, m = (step_ms[n] for n in cases)
            print(f"layer tail: one {size} decode step's tail at these times ({L} layers x "
                  f"(2 norms, rope, SiLU) + the final norm): kernels "
                  f"{(2 * L + 1) * a[0] + L * (r[0] + m[0]):.3f} ms, plain chain "
                  f"{(2 * L + 1) * a[1] + L * (r[1] + m[1]):.3f} ms")
            del x, y, qkv, gate, up, cache, plain_cache
        torch.cuda.empty_cache()
        for name in ("add_rms_norm", "rope_kv_write", "silu_mul"):
            ms, plain_ms, bound_ms = rows[("7b", name)]
            self.kernels[name] = {
                "name": name, "route": "cuda",
                "source": "ospo_tpu_torch/ops/csrc/layer_tail.cu",
                "replaces": None, "launches": None, "max_abs_err": None,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes", "library_ms": None,
                "library_note": "no single PyTorch call computes this chain; the 7B "
                                "decode step's shape, CUDA-graph replay, hot in L2",
            }

    def text_kernels(self):
        """The flash forward at the step-2 prefix prefill and the decode
        kernel at the text plain-path shape (module docstring)."""
        from ospo_tpu_torch.ops import decode_attention as da
        from ospo_tpu_torch.ops import flash_attention as fa

        sys.path[:0] = [os.path.join(ROOT, "tests")]
        import flash_fwd_reference as fref

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(21)
        common, T = step2_prefix()
        H, D = 32, 128
        q, k, v = (torch.randn((1, T, H, D), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        mask = torch.zeros((1, T), dtype=torch.int32, device=dev)
        mask[0, T - common:] = 1
        valid = mask[0] > 0
        out, l, m = fa.flash_attention(q, k, v, mask, return_stats=True)
        ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, mask)
        torch.cuda.synchronize()
        # valid query rows only (a left-pad row reads no valid key)
        errs = [max_err(out[:, valid], ref[:, valid]),
                max_err(l[..., valid], l_ref[..., valid])
                / float(l_ref[..., valid].abs().max()),
                max_err(m[..., valid], m_ref[..., valid])]
        ok = (torch.allclose(out[:, valid].float(), ref[:, valid].float(),
                             atol=1e-2, rtol=1e-2)
              and errs[1] < 1e-5 and errs[2] < 1e-4)
        what = (f"B=1 T=S={T} H={H} bf16 causal, {T - common} left-pad rows "
                f"(step-2 prefix prefill)")
        self.check(ok, f"flash_fwd {what}: max|dO|={errs[0]:.3g} (tol "
                       f"1e-2+1e-2|O|), max|dl|/|l|={errs[1]:.3g} (tol 1e-5), "
                       f"max|dm|={errs[2]:.3g} (tol 1e-4), valid rows")
        entry = self.kernels.get("flash_fwd")
        if entry:
            entry["max_abs_err"] = max(entry["max_abs_err"], errs[0])
        args = fref.budget_case(q, k, v, mask)
        got = fa.flash_attention(*args)[:, valid]
        exact = fref.exact_forward(*args)[:, valid]
        plain = fa.flash_attention_plain(*args)[0][:, valid]
        err, err_plain = fref._rms(got, exact), fref._rms(plain, exact)
        self.check(err <= fref.BUDGET * err_plain,
                   f"flash_fwd {what} against float64: RMS error {err:.4g}, "
                   f"plain forward {err_plain:.4g} (ratio "
                   f"{err / err_plain:.3f}, tol {fref.BUDGET:g})")
        del args, got, exact, plain
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v, mask), 10)
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, mask), 2, 1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        allowed = (mask[:, None, None, :] > 0) & torch.ones(
            (T, T), dtype=torch.bool, device=dev).tril()[None, None]
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allowed), 10)
        # the valid rows' causal products, each input read and output written
        # once (q, k, v, the mask, O, and m and l in fp32)
        flops = 4.0 * H * D * common * (common + 1) / 2
        nbytes = 4 * T * H * D * 2 + T * 4 + 2 * H * T * 4
        bound_ms = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
        print(f"flash_fwd {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({flops / 1e9:.2f}"
              f" GFLOP, {nbytes / 1e6:.1f} MB, bound by "
              f"{'operations' if flops / PEAK_BF16 > nbytes / PEAK_BYTES else 'bytes'})")
        del q, k, v, out, ref, qt, kt, vt, allowed
        torch.cuda.empty_cache()

        # decode: the step-1 prompt on the plain program, int8 cache
        L, B, dh = 30, 64, 128
        n_prompt, t_prompt = step1_prompt_bucket()
        S, cur = t_prompt + 256, t_prompt + 128
        q = torch.randn((B, 1, H, dh), generator=g, device=dev).to(torch.bfloat16)
        kc, vc = (torch.randint(-127, 128, (L, S, H, B, dh), generator=g,
                                device=dev, dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((L, S, H, B), generator=g, device=dev) * 0.02
                  for _ in range(2))
        mask = torch.ones((B, S), dtype=torch.int32, device=dev)
        mask[:, :t_prompt - n_prompt] = 0     # the left-padded prompt window
        worst = 0.0
        for layer, c in ((0, t_prompt + 1), (17, cur), (29, S)):
            out = da.decode_attention(q, kc, vc, layer, c, mask, ks, vs)
            ref = da.decode_attention_plain(q, kc, vc, layer, c, mask, ks, vs)
            err = max_err(out, ref)
            worst = max(worst, err)
            self.check(torch.allclose(out.float(), ref.float(), atol=1e-4,
                                      rtol=2 ** -7),
                       f"decode int8 cache L={L} S={S} H={H} B={B} layer "
                       f"{layer} cur_len {c} (text plain path): max|d|="
                       f"{err:.3g} (tol 1e-4+2^-7|ref|)")
        entry = self.kernels.get("decode_attention")
        if entry:
            entry["max_abs_err"] = max(entry["max_abs_err"], worst)
        ms = cuda_ms(lambda: da.decode_attention(q, kc, vc, 17, cur, mask, ks, vs), 50)
        plain_ms = cuda_ms(lambda: da.decode_attention_plain(
            q, kc, vc, 17, cur, mask, ks, vs), 3, 1)
        nbytes = 2 * cur * H * B * dh + 2 * cur * H * B * 4 + 2 * B * H * dh * 2 \
            + B * cur * 4
        print(f"decode_attention int8 B={B} cur_len {cur} (text plain path): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{nbytes / PEAK_BYTES * 1e3:.5f} ms ({nbytes / 1e6:.1f} MB)")
        del kc, vc, ks, vs
        torch.cuda.empty_cache()

    def scoring_kernels(self):
        """The flash forward at step 4b's prefills (module docstring): the
        B = 1 pre-image segment, and the single-segment program's B = 8
        slice (its byte-tokenizer bucket, and 640, the per-image remainder's
        bucket), left-padded, bf16."""
        from ospo_tpu_torch.ops import flash_attention as fa

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(23)
        H, D = 32, 128
        pre = score_buckets(True)[0]
        single = score_buckets(False)[0]
        cases = (("pre-image prefill", 1, pre["pre_c"], pre["pre_n"]),
                 ("single-segment prefill", 8, single["p_b"], single["rest"]),
                 ("single-segment prefill at the remainder bucket", 8,
                  pre["p_b"], pre["rest"]))
        entry = self.kernels.get("flash_fwd")
        for what, B, T, n in cases:
            q, k, v = (torch.randn((B, T, H, D), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(3))
            mask = torch.zeros((B, T), dtype=torch.int32, device=dev)
            mask[:, T - n:] = 1
            out, l, m = fa.flash_attention(q, k, v, mask, return_stats=True)
            ref, l_ref, m_ref = fa.flash_attention_plain(q, k, v, mask)
            torch.cuda.synchronize()
            valid = mask[0] > 0
            errs = [max_err(out[:, valid], ref[:, valid]),
                    max_err(l[..., valid], l_ref[..., valid])
                    / float(l_ref[..., valid].abs().max()),
                    max_err(m[..., valid], m_ref[..., valid])]
            ok = (torch.allclose(out[:, valid].float(), ref[:, valid].float(),
                                 atol=1e-2, rtol=1e-2)
                  and errs[1] < 1e-5 and errs[2] < 1e-4)
            shape = (f"B={B} T=S={T} H={H} bf16 causal, {T - n} left-pad "
                     f"rows ({what}, step 4b)")
            self.check(ok, f"flash_fwd {shape}: max|dO|={errs[0]:.3g} (tol "
                           f"1e-2+1e-2|O|), max|dl|/|l|={errs[1]:.3g} (tol "
                           f"1e-5), max|dm|={errs[2]:.3g} (tol 1e-4), valid rows")
            if entry:
                entry["max_abs_err"] = max(entry["max_abs_err"], errs[0])
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v, mask), 20)
            plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, mask), 3, 1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            allowed = (mask[:, None, None, :] > 0) & torch.ones(
                (T, T), dtype=torch.bool, device=dev).tril()[None, None]
            lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=allowed), 20)
            flops = 4.0 * H * D * B * n * (n + 1) / 2
            nbytes = 4 * B * T * H * D * 2 + B * T * 4 + 2 * B * H * T * 4
            bound_ms = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
            print(f"flash_fwd {shape}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                  f"{bound_ms:.5f} ms ({flops / 1e9:.2f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB, bound by "
                  f"{'operations' if flops / PEAK_BF16 > nbytes / PEAK_BYTES else 'bytes'})")
            del q, k, v, out, ref, qt, kt, vt, allowed
        torch.cuda.empty_cache()

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
            n0 = kernel_launches()
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
            moved = launched(n0)["int4_matmul_group"]
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

    def small_text(self):
        """The small model (head dim 128, fp32) decoding text greedily on
        the GPU (flash forward, decode kernel, int8 KV) and on the CPU (the
        plain versions), same weights: the shared-prefix and the plain
        programs' ids must be identical, the first step's logits within
        1e-2 max|ref|."""
        import dataclasses

        from ospo_tpu_torch.engine.text_engine import TextGenEngine
        from ospo_tpu_torch.models import janus, llama
        from ospo_tpu_torch.processing import Processor
        from ospo_tpu_torch.tokenizer import ByteTokenizer

        cfg = dataclasses.replace(
            janus.tiny_janus_config(),
            language=llama.tiny_config(hidden_size=256, intermediate_size=512,
                                       num_heads=2))
        cpu_model = janus.JanusModel.init(cfg, seed=3, device="cpu", vision=False)
        gpu_model = janus.JanusModel(cfg, _tree_map(cpu_model.params,
                                                    lambda t: t.to("cuda")),
                                     torch.device("cuda"))
        proc = Processor(ByteTokenizer(cfg.language.vocab_size))
        head = "You are given an object and must list its attributes, as in " \
               "these examples: "
        prompts = [head + "a red apple", head + "two dogs in the park",
                   head + "an umbrella"]
        first = []
        lm_logits = janus.lm_logits

        def capture(params, hidden):
            """Keeps each engine run's first logits (a None marks a run)."""
            out = lm_logits(params, hidden)
            if first and first[-1] is None:
                first[-1] = out.float().cpu()
            return out

        janus.lm_logits = capture
        try:
            for shared in (True, False):
                ids, first[:], steps = [], [], []
                n0 = kernel_launches()
                for model in (cpu_model, gpu_model):
                    eng = TextGenEngine(model, proc, max_new_tokens=24,
                                        do_sample=False, kv_quant="int8",
                                        shared_prefix=shared)
                    eng.step_hook = steps.append
                    first.append(None)
                    ids.append(eng.generate_ids(prompts))
                moved = tuple(launched(n0, "flash_fwd", "decode_attention").values())
                # 2 layers: the prompt (or prefix) prefill, and the plain
                # program's cached steps on the GPU
                n_gpu = len(steps) // 2
                want = (2, 0) if shared else (2, 2 * (n_gpu - 1))
                err = max_err(first[1], first[0])
                scale = float(first[0].abs().max())
                self.check(bool((ids[0] == ids[1]).all()) and err <= 1e-2 * scale
                           and moved == want,
                           f"small text decode GPU vs CPU ({'shared-prefix' if shared else 'plain'} "
                           f"program, greedy, fp32, int8 KV): ids identical "
                           f"{bool((ids[0] == ids[1]).all())}; first logits "
                           f"max|d|={err:.3g}, max|ref|={scale:.3g} (tol 1e-2 "
                           f"max|ref|); flash/decode launches {moved} "
                           f"(expected {want})")
        finally:
            janus.lm_logits = lm_logits

    def small_scoring(self):
        """The small model (head dim 128, fp32, int8 weights, the tiny
        SigLIP at head dim 16) scoring 3 images on the GPU (the flash
        forward in every trunk prefill, the plain ViT and suffix forms) and
        on the CPU, same weights: p_yes and p_no per (image, question)
        within 1e-3 of the CPU's value, relative, for the pre-image and the
        single-segment programs, each with the int8 and the fp32 cache."""
        import dataclasses

        import numpy as np

        from ospo_tpu_torch.engine.scoring import ScoringEngine
        from ospo_tpu_torch.image_processing import ImageProcessor
        from ospo_tpu_torch.models import janus, llama
        from ospo_tpu_torch.processing import Processor
        from ospo_tpu_torch.tokenizer import ByteTokenizer

        cfg = dataclasses.replace(
            janus.tiny_janus_config(),
            language=llama.tiny_config(hidden_size=256, intermediate_size=512,
                                       num_heads=2))
        cpu_model = janus.JanusModel.init(cfg, seed=5, quantize="int8",
                                          device="cpu")
        gpu_model = janus.JanusModel(cfg, _tree_map(cpu_model.params,
                                                    lambda t: t.to("cuda")),
                                     torch.device("cuda"))
        proc = Processor(ByteTokenizer(cfg.language.vocab_size),
                         ImageProcessor(image_size=cfg.image_size),
                         num_image_tokens=cfg.num_image_tokens)
        rng = np.random.default_rng(5)
        images = [rng.integers(0, 256, shape).astype(np.uint8)
                  for shape in ((32, 32, 3), (40, 24, 3), (20, 50, 3))]
        questions = [["Is there a dog?", "Is it red?", "Does it match?"],
                     ["Is the sky blue?", "Does it match the prompt?"],
                     ["Is there a cat?", "Is it big?", "Is it outdoors?",
                      "Does it match?"]]
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False   # the patch conv in fp32
        try:
            for pre in (True, False):
                for kv in ("int8", False):
                    outs = []
                    n0 = kernel_launches()
                    for model in (cpu_model, gpu_model):
                        eng = ScoringEngine(model, proc, kv_quant=kv,
                                            pre_image_prefix=pre)
                        outs.append(eng.score_images_multi(images, questions))
                    moved = launched(n0)["flash_fwd"]
                    ps = [(m[k], n[k]) for a, b in zip(*outs) for m, n in zip(
                        a["answer_metadata"], b["answer_metadata"])
                        for k in ("p_yes", "p_no")]
                    worst = max(abs(g - c) / abs(c) for c, g in ps)
                    self.check(worst <= 1e-3 and moved == cfg.language.num_layers
                               and len(ps) == 2 * 9,
                               f"small scoring GPU vs CPU ({'pre-image' if pre else 'single-segment'} "
                               f"program, {kv or 'fp32'} cache, int8 weights): "
                               f"max |dp|/|p| = {worst:.3g} over {len(ps)} "
                               f"p's (tol 1e-3); flash launches {moved} "
                               f"(expected {cfg.language.num_layers}: one "
                               f"trunk prefill from position 0)")
        finally:
            torch.backends.cudnn.allow_tf32 = tf32

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
        from ospo_tpu_torch.ops.pixels import normalize_pixels
        from ospo_tpu_torch.train.trainer import SimPOTrainer

        cfg, cpu_model, proc, config, batch = self._small_train_setup(
            torch.float32)
        gpu_model = janus.JanusModel(
            cfg, _tree_map(cpu_model.params, lambda t: t.to("cuda")),
            torch.device("cuda"))
        trainers = [SimPOTrainer(config, m, proc) for m in (cpu_model, gpu_model)]
        self._set_lora(trainers)
        n0 = kernel_launches()
        out = [tr.loss_and_grads(*batch) for tr in trainers]
        torch.cuda.synchronize()
        moved = tuple(launched(n0, *FLASH_KERNELS).values())
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
            n0 = kernel_launches()
            if plain:
                fa.flash_dq, fa.flash_dkv = fa.flash_dq_plain, fa.flash_dkv_plain
            try:
                outs.append(trainer.loss_and_grads(*batch))
                torch.cuda.synchronize()
            finally:
                fa.flash_dq, fa.flash_dkv = kernels
            moved.append(tuple(launched(n0, *FLASH_KERNELS).values()))
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
        from ospo_tpu_torch.pipeline import step3
        from ospo_tpu_torch.utils.png import read_png

        tmp = self.workdir  # the PNG tree stays for phase 5
        config = Config.from_nested({
            **STEP3_CONFIG, "model_path": None, "model_preset": "7b",
            "data_path": FIXTURE, "e_idx": N_ITEMS,
            "save_path": os.path.join(tmp, "step3")})

        torch.cuda.reset_peak_memory_stats()
        n0 = kernel_launches()
        t0 = time.time()
        stats = step3.main(config)
        torch.cuda.synchronize()
        wall = time.time() - t0
        d = launched(n0)
        counts = {k: d[k] for k in ("flash_fwd", "decode_attention", "w8a16_matmul")}
        self.check(d["int4_matmul_row"] == d["int4_matmul_group"] == 0,
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
        self.check(counts["w8a16_matmul"] == 4 * layers * (n_img - 1) * groups,
                   f"w8a16_matmul launches {counts['w8a16_matmul']} == 4 x "
                   f"{layers} x {n_img - 1} x {groups} groups (q, k and v; o; "
                   "gate and up; down)")
        tail = {k: d[k] for k in ("add_rms_norm", "rope_kv_write", "silu_mul")}
        forwards = n_img * groups   # a group's prefill and its 575 cached steps
        print(f"main path step 3 tail launches: {tail}; a step: "
              f"{ {k: n / forwards for k, n in tail.items()} }")
        self.check(tail == {"add_rms_norm": (2 * layers + 1) * forwards,
                            "rope_kv_write": layers * forwards,
                            "silu_mul": layers * forwards},
                   f"tail launches {tail} == {2 * layers + 1}, {layers} and {layers} "
                   f"a forward x {n_img} forwards x {groups} groups (two norms a "
                   "layer and the final one; rope and the cache write; SiLU·up)")
        for name, n in {**counts, **tail}.items():
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
        n0 = kernel_launches()
        t0 = time.time()
        trainer = step5.main(config)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launched(n0, *FLASH_KERNELS)
        print(f"main path step 5 launches: {counts}")
        for name, n in counts.items():
            self.launches[name] = self.launches.get(name, 0) + n
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = trainer.update_seconds
        stats = trainer.stats
        self.lora_train = {"peak_gb": peak_gb, "steps": list(steps)}
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


    # -- phases 6, 7, 13 and 14a -------------------------------------------
    def step3_group(self, tag: str, overrides: dict,
                    items: int = N_ITEMS) -> dict:
        """Step 3 (``step3.main``) at the 7B width and depth with
        ``overrides`` on ``configs/step3.yaml``, over one group of ``items``
        CFG pairs (24: M = 48 in every decode projection): the first prompt
        of each of the first ``items`` fixture items, their other prompts
        left empty (step 3 skips an empty prompt), so the tree holds
        ``items`` images; checks them.
        → the run's statistics, its kernel launches, its peak memory and the
        engine ``main`` built (its model kept alive)."""
        import gc

        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.pipeline import step3
        from ospo_tpu_torch.utils.png import read_png

        gc.collect()  # the previous phase's model goes first
        torch.cuda.empty_cache()
        print(f"device memory before step 3 ({tag}): "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        data = read_json(FIXTURE)[:items]
        for sample in data:
            sample["long_prompt"] = [sample["long_prompt"][0], "", ""]
            sample["negative_long_prompt"] = ["", "", ""]
        root = os.path.join(self.workdir, "step3_" + tag.replace(" ", "_"))
        os.makedirs(root, exist_ok=True)
        data_path = os.path.join(root, "long_prompt.json")
        with open(data_path, "w") as f:
            json.dump(data, f)
        config = Config.from_nested({
            **STEP3_CONFIG, "model_path": None, "model_preset": "7b",
            **overrides, "data_path": data_path, "e_idx": items,
            "save_path": os.path.join(root, "out")})
        engines, peaks = [], {"init": 0.0, "tokens": 0.0, "vq": 0.0}
        engine_cls = step3.ImageGenEngine

        def keep(*args, **kw):
            """Keeps the engine ``main`` builds, and reads the peak memory of
            the model set-up, of token generation and of the VQ decode."""
            eng = engine_cls(*args, **kw)
            gen, vq = eng._generate_tokens_device, eng._decode_tokens

            def generate(*a, **k):
                key = "tokens" if peaks["tokens"] or peaks["vq"] else "init"
                peaks[key] = max(peaks[key], torch.cuda.max_memory_allocated() / 1e9)
                torch.cuda.reset_peak_memory_stats()
                return gen(*a, **k)

            def decode(*a, **k):
                peaks["tokens"] = max(peaks["tokens"],
                                      torch.cuda.max_memory_allocated() / 1e9)
                torch.cuda.reset_peak_memory_stats()
                out = vq(*a, **k)
                peaks["vq"] = max(peaks["vq"], torch.cuda.max_memory_allocated() / 1e9)
                return out

            eng._generate_tokens_device, eng._decode_tokens = generate, decode
            engines.append(eng)
            return eng

        torch.cuda.reset_peak_memory_stats()
        n0 = kernel_launches()
        step3.ImageGenEngine = keep
        t0 = time.time()
        try:
            stats = step3.main(config)
            torch.cuda.synchronize()
        finally:
            step3.ImageGenEngine = engine_cls
        wall = time.time() - t0
        counts = launched(n0, "flash_fwd", "decode_attention", "int4_matmul_row",
                          "int4_matmul_group")
        for name, n in counts.items():
            self.launches[name] = self.launches.get(name, 0) + n
        peak_gb = max(torch.cuda.max_memory_allocated() / 1e9, *peaks.values())
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        rate = stats["image_tokens"] / stats["seconds"]
        print(f"step 3 {tag}: {stats['groups']} group(s), {stats['images']} "
              f"images, {stats['image_tokens']} image tokens in "
              f"{stats['seconds']:.1f} s of serving ({rate:.1f} img-tok/s); "
              f"step3.main {wall:.1f} s with the 7B init; peak memory "
              f"{peak_gb:.2f} GB (model set-up {peaks['init']:.2f}, token "
              f"generation {peaks['tokens']:.2f}, VQ decode "
              f"{peaks['vq']:.2f}); launches {counts}; card {smi}")
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
        self.check(not bad and n_png == items and stats["images"] == items
                   and stats["groups"] == 1,
                   f"step 3 {tag}: one group, {n_png} PNGs (384x384x3 uint8, "
                   f"non-constant) + metadata.json; bad: {bad[:3]}")
        return {"stats": stats, "counts": counts, "peak_gb": peak_gb,
                "tokens_gb": peaks["tokens"], "rate": rate,
                "engine": engines[0] if engines else None}

    def int4_path(self, mode: str):
        """Step 3 as :meth:`step3_group` with ``quantize: mode`` (int4g: the
        group kernel; int4 and int4n: the row kernel)."""
        run = self.step3_group(f"quantize {mode}", {"quantize": mode})
        counts = run["counts"]
        kname = "int4_matmul_group" if mode == "int4g" else "int4_matmul_row"
        other = counts["int4_matmul_row" if mode == "int4g"
                       else "int4_matmul_group"]
        layers, steps = 30, 575
        self.check(counts[kname] == 7 * layers * steps and other == 0,
                   f"{kname} launches {counts[kname]} == 7 x {layers} x "
                   f"{steps} x 1 group, the other int4 kernel {other}")
        self.check(counts["flash_fwd"] == layers
                   and counts["decode_attention"] == layers * steps,
                   f"flash_fwd {counts['flash_fwd']} == {layers}, "
                   f"decode_attention {counts['decode_attention']} == "
                   f"{layers} x {steps}")

    # -- phase 8 ---------------------------------------------------------
    def text_path(self):
        """Steps 1, 2 and 4a at the 7B width (module docstring, phase 8)."""
        import gc

        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.pipeline import model_factory, step1, step2, step4

        gc.collect()  # the previous phase's model goes first
        torch.cuda.empty_cache()
        root = os.path.join(self.workdir, "text")
        model7b = {"model_path": None, "model_preset": "7b"}
        c1 = Config.from_nested({**STEP1_CONFIG, **model7b, "category": "object",
                                 "max_len": 1,
                                 "save_path": os.path.join(root, "step1")})
        t0 = time.time()
        shared = model_factory.get_model(c1)
        torch.cuda.synchronize()
        print(f"text path: 7B int8 model (drop_vision, lm_head) built in "
              f"{time.time() - t0:.1f} s, {torch.cuda.memory_allocated() / 1e9:.2f}"
              f" GB allocated")
        group = [r for r in read_json(BASE_FIXTURE) if r["sub_category"] == "complex"]
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, "base_complex.json"), "w") as f:
            json.dump(group, f)
        gen2 = {**STEP2_CONFIG["generation_config"], "max_new_tokens": STEP2_NEW_TOKENS}
        stages = (
            ("step 1", step1, c1),
            ("step 2", step2, Config.from_nested({
                **STEP2_CONFIG, **model7b, "generation_config": gen2,
                "data_path": os.path.join(root, "base_complex.json"),
                "save_path": os.path.join(root, "step2")})),
            ("step 4a", step4, Config.from_nested({
                **STEP4_CONFIG, **model7b, "image_path": None,
                "generation_config": {**STEP4_CONFIG["generation_config"],
                                      "max_new_tokens": STEP4A_NEW_TOKENS},
                "data_path": FIXTURE, "save_path": os.path.join(root, "step4")})),
        )
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        totals = {"flash_fwd": 0, "decode_attention": 0}
        for name, module, config in stages:
            module.get_model, saved = (lambda _c: shared), module.get_model
            torch.cuda.reset_peak_memory_stats()
            n0 = kernel_launches()
            try:
                with _TextRecorder() as rec:
                    module.main(config)
            finally:
                module.get_model = saved
            counts = launched(n0, "flash_fwd", "decode_attention")
            for k, n in counts.items():
                totals[k] += n
            st = rec.summary()
            print(f"text {name}: {st['calls']} generate call(s), batch "
                  f"{st['batch']} (bucket {st['bucket']}), prefix bucket C "
                  f"{st['prefix']}, tail bucket {st['tail']}, "
                  f"{st['tokens']} tokens in {st['seconds']:.2f} s "
                  f"({st['tok_per_s']:.1f} tok/s), mid-decode step "
                  f"{st['mid_step_ms']:.2f} ms (device timeline) / "
                  f"{st['mid_host_ms']:.2f} ms (host), peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
                  f"{counts}; card {smi}")
            want = {"flash_fwd": 30 * st["calls"],
                    "decode_attention": 30 * st["plain_steps"]}
            self.check(counts == want and st["tokens"] > 0,
                       f"text {name} launches {counts} == {want} (30 layers x "
                       f"one prefill a call; decode kernel on the plain "
                       f"program's cached steps)")
        for k, n in totals.items():
            self.launches[k] = self.launches.get(k, 0) + n
        self.check(totals["flash_fwd"] > 0,
                   f"text path launched flash_fwd {totals['flash_fwd']} times")

        s1 = os.path.join(root, "step1")
        elements = read_json(os.path.join(s1, "object_element.json"))
        fix = os.path.join(s1, "fixture")
        os.makedirs(fix)
        for name in os.listdir(os.path.dirname(BASE_FIXTURE)):
            if name.endswith("_element.json"):
                shutil.copy(os.path.join(os.path.dirname(BASE_FIXTURE), name), fix)
        quotas = {}
        for r in read_json(BASE_FIXTURE):
            quotas[r["sub_category"]] = quotas.get(r["sub_category"], 0) + 1
        step1.combine_prompt(Config.from_nested({"save_path": fix,
                                                 "category_num": quotas}))
        base = read_json(os.path.join(fix, "base_prompt.json"))
        self.check(isinstance(elements, list) and len(base) == 40 and all(
            set(r) == {"prompt", "category", "sub_category", "item_id"}
            for r in base), f"step 1: object_element.json a list of "
            f"{len(elements)}; combine_prompt over the fixture elements: "
            f"{len(base)} base prompts (expected 40)")
        neg = read_json(os.path.join(root, "step2", "negative_prompt.json"))
        dense = read_json(os.path.join(root, "step2", "long_prompt.json"))
        self.check([r["item_id"] for r in dense] == [r["item_id"] for r in group]
                   and len(neg) == len(group) and all(
                       len(r["negative_prompt"]) == len(r["long_prompt"])
                       == len(r["negative_long_prompt"]) == 3 for r in dense),
                   f"step 2: negative_prompt.json and long_prompt.json hold the "
                   f"{len(group)} complex items with 3 prompts each")
        vqa = read_json(os.path.join(root, "step4", "vqa_prompt.json"))
        self.check(len(vqa) == 40 and all(
            r["question"][-1] == step4.GLOBAL_QUESTION.format(r["prompt"].rstrip("."))
            for r in vqa), f"step 4a: vqa_prompt.json holds {len(vqa)} items "
            f"(expected 40), each ending with the global question")
        del shared


    # -- phase 9 ---------------------------------------------------------
    def score_path(self):
        """Step 4b at the 7B width over phase 4's PNG tree (module
        docstring, phase 9)."""
        import gc

        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.pipeline import step4

        gc.collect()  # the previous phase's model goes first
        torch.cuda.empty_cache()
        items = score_items()
        image_root = os.path.join(self.workdir, "step3")
        save = os.path.join(self.workdir, "step4b")
        os.makedirs(save)
        with open(os.path.join(save, "vqa_prompt.json"), "w") as f:
            json.dump(items, f)
        config = Config.from_nested({
            **STEP4_CONFIG, "model_path": None, "model_preset": "7b",
            "image_path": image_root, "save_path": save})
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        torch.cuda.reset_peak_memory_stats()
        n0 = kernel_launches()
        t0 = time.time()
        with _ScoreRecorder(step4) as rec:
            step4.main(config)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches, suffix = (launched(n0)[k] for k in ("flash_fwd", "suffix_attention"))
        for k, n in (("flash_fwd", launches), ("suffix_attention", suffix)):
            self.launches[k] = self.launches.get(k, 0) + n
        st = rec.summary()
        summary = read_json(os.path.join(save, "score_summary.json"))
        train = read_json(os.path.join(save, "train.json"))
        n_images = sum(c["images"] for c in summary.values())
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"step 4b: {n_images} images in {st['loop_s']:.2f} s of the "
              f"scoring loop ({n_images / st['loop_s']:.2f} images/s, model "
              f"set-up excluded); step4.main {wall:.1f} s with the 7B init; "
              f"{st['slices']} slices of {st['rows']} images, buckets "
              f"(p_b, t_b, pre) {st['buckets']}; per slice on the device: ViT "
              f"{st['vit_ms']:.2f} ms, pre-image prefill {st['pre_ms']:.2f} ms, "
              f"image prefill {st['prefill_ms']:.2f} ms, suffixes "
              f"{st['suffix_ms']:.2f} ms (sum {st['device_ms']:.2f} ms of "
              f"{st['slice_ms']:.2f} ms a slice on the host's clock); peak "
              f"memory {peak_gb:.2f} GB; flash launches {launches}; engine "
              f"counts {st['counts']}; {len(train)} pairs; card {smi}")
        print(f"step 4b per-category summary: {summary}")
        self.check(n_images == 6 * N_ITEMS and all(
            c["scored"] == c["images"] for c in summary.values()),
            f"step 4b scored every image: {n_images} images (expected "
            f"{6 * N_ITEMS}), scored == images in every category")
        self.check(st["counts"] == {"oom_retries": 0, "unshared_calls": 0,
                                    "per_image_retries": 0},
                   f"step 4b took no OOM retry, no unshared fallback and no "
                   f"per-image retry: {st['counts']}")
        self.check(st["slices"] > 0 and launches == 30 * st["slices"],
                   f"step 4b flash_fwd launches {launches} == 30 x "
                   f"{st['slices']} shared-program slices (the B = 1 "
                   f"pre-image prefill)")
        self.check(suffix == 30 * st["suffix_passes"],
                   f"step 4b suffix_attention launches {suffix} == 30 layers x "
                   f"{st['suffix_passes']} question passes over the slices")
        self.check(all(set(r) == TRAIN_KEYS and set(r["metadata"]) == TRAIN_META_KEYS
                       and set(r["metadata"]["score_metadata"]) == {
                           "local_gap", "global_gap", "preference_strength"}
                       for r in train) and sum(
                           c["pairs"] for c in summary.values()) == len(train),
                   f"train.json: {len(train)} records with the JAX package's "
                   f"schema, as many as the summary's pairs")


    # -- phase 10 --------------------------------------------------------
    def inference_path(self):
        """The inference CLI at the 7B width, round-2 generation from phase
        5's LoRA checkpoint (module docstring, phase 10)."""
        import gc

        from ospo_tpu_torch import config as config_lib
        from ospo_tpu_torch.engine.image_engine import ImageGenEngine
        from ospo_tpu_torch.ops import quant
        from ospo_tpu_torch.pipeline import inference
        from ospo_tpu_torch.train import checkpoint as ckpt_lib
        from ospo_tpu_torch.utils.png import read_png

        gc.collect()  # the previous phase's model goes first
        torch.cuda.empty_cache()
        root = os.path.join(self.workdir, "inference")
        os.makedirs(root)
        prompts = inference_prompts()
        data_path = os.path.join(root, "prompts.json")
        with open(data_path, "w") as f:
            json.dump(prompts, f)
        out = os.path.join(root, "results")
        ckpt = os.path.join(self.workdir, "step5", "ospo")
        config = config_lib.compose_config(
            os.path.join(ROOT, "configs"), "inference", overrides=[
                "model_path=null", "model_preset=7b", "seed=[0]",
                f"data_path={data_path}", f"save_path={out}",
                f"ckpt_path={ckpt}"])
        self.check(config.batch_size == 24 and config.quantize == "int8"
                   and config.kv_quant == "int8" and config.kv_layout == "shbd",
                   f"configs/inference.yaml composes to batch 24, int8 weights, "
                   f"int8 shbd KV: {config.batch_size}, {config.quantize}, "
                   f"{config.kv_quant}, {config.kv_layout}")
        torch.cuda.reset_peak_memory_stats()
        n0 = kernel_launches()
        engines = []
        build = inference.build_engine

        def keep_engine(*a, **k):
            engines.append(build(*a, **k))
            return engines[-1]

        t0 = time.time()
        inference.build_engine = keep_engine
        try:
            with _Timed([(inference, "generate_all"),
                         (ckpt_lib, "merge_lora_checkpoint"),
                         (quant, "quantize_layers")]) as timed:
                inference.main(config)
        finally:
            inference.build_engine = build
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launched(n0, "flash_fwd", "decode_attention")
        for name, n in counts.items():
            self.launches[name] = self.launches.get(name, 0) + n
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        gen_s = timed.seconds["generate_all"]
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        n_tok = len(prompts) * 576
        print(f"inference: {len(prompts)} prompts, {n_tok} image tokens in "
              f"{gen_s:.2f} s of generate_all ({n_tok / gen_s:.1f} img-tok/s, "
              f"PNG writes included); LoRA merge "
              f"{timed.seconds['merge_lora_checkpoint']:.2f} s, int8 quantize "
              f"{timed.seconds['quantize_layers']:.2f} s; inference.main "
              f"{wall:.1f} s with the 7B init; peak memory {peak_gb:.2f} GB; "
              f"launches {counts}; card {smi}")
        self.check(counts == {"flash_fwd": 30, "decode_attention": 30 * 575},
                   f"inference launches {counts} == 30 flash_fwd (one batch of "
                   f"24) and 30 x 575 decode_attention")
        files = sorted(os.listdir(out))
        own = [f"{p}_0.png".replace("/", "_") for p in prompts]
        long_names = [n for n in own if len(n.encode()) > 255]
        fallback = [f for f in files if f.startswith("longprompt_0_")]
        print(f"inference: {len(fallback)} of {len(prompts)} prompts took the "
              f"longprompt_0_NNNN.png fallback (names over 255 bytes)")
        bad = []
        for f in files:
            img = read_png(os.path.join(out, f))
            if img.shape != (384, 384, 3) or img.dtype.name != "uint8" \
                    or int(img.max()) == int(img.min()):
                bad.append(f"{f[:40]} {img.shape}")
        expect = sorted([n for n in own if n not in long_names] + [
            f"longprompt_0_{i:04d}.png" for i in range(len(long_names))])
        self.check(files == expect and len(long_names) >= 1 and not bad,
                   f"inference tree: {len(files)} PNGs for {len(prompts)} "
                   f"prompts, {len(long_names)} under the fallback name, no "
                   f"error_sample.json, each 384x384x3 uint8 and non-constant; "
                   f"bad: {bad[:3]}")

        # the resume pass: generate_all again on the first pass's engine (no
        # second 7B build), the engine's draws replaced by the first pass's
        # images of the prompts asked (cut for time: the pass checks what is
        # asked, not the draws)
        asked = []
        real = ImageGenEngine.generate_from_raw_prompts
        drawn = {p: read_png(os.path.join(out, f"longprompt_0_{i:04d}.png"))
                 for i, p in enumerate(p for p, n in zip(prompts, own)
                                       if n in long_names)}

        def record(engine, raw_prompts, seed=0):
            asked.extend(raw_prompts)
            return [drawn[p] for p in raw_prompts]

        ImageGenEngine.generate_from_raw_prompts = record
        try:
            inference.generate_all(config, engines[0], inference.shard_for_process(
                inference.read_json(config.data_path)))
        finally:
            ImageGenEngine.generate_from_raw_prompts = real
        engines.clear()
        own_exist = [p for p, n in zip(prompts, own) if n not in long_names]
        self.check(not set(asked) & set(own_exist)
                   and sorted(asked) == sorted(drawn)
                   and sorted(os.listdir(out)) == files,
                   f"a second generate_all asked for {len(asked)} prompt(s), "
                   f"the {len(drawn)} under the fallback name and none of the "
                   f"{len(own_exist)} whose own names exist; the tree is "
                   "unchanged")

    # -- phase 11 --------------------------------------------------------
    def full_finetune_path(self):
        """Step 5 in full fine-tune mode at the Janus-Pro-1B width (module
        docstring, phase 11)."""
        import gc

        import numpy as np

        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.pipeline import model_factory, step5
        from ospo_tpu_torch.train import checkpoint as ckpt_lib
        from ospo_tpu_torch.train.optim import leaves

        gc.collect()  # the previous phase's model goes first
        torch.cuda.empty_cache()
        free_gb = shutil.disk_usage(self.workdir).free / 1e9
        self.check(free_gb >= FULL_CKPT_GB,
                   f"{free_gb:.1f} GB free under {self.workdir} for the 1B "
                   f"full checkpoint (needs {FULL_CKPT_GB} GB: bf16 language "
                   "model and fp32 moments)")
        if free_gb < FULL_CKPT_GB:
            return
        data_path = os.path.join(self.workdir, "step4", "train.json")
        save_path = os.path.join(self.workdir, "step5_full")
        config = Config.from_nested(merged(merged(STEP5_CONFIG, step5_overrides(
            data_path, os.path.join(self.workdir, "step3"), save_path)),
            {"use_peft": False, "model": {"model_preset": "1b"}}))
        torch.cuda.reset_peak_memory_stats()
        n0 = kernel_launches()
        t0 = time.time()
        with _Timed([(ckpt_lib, "save_checkpoint")]) as timed:
            trainer = step5.main(config)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launched(n0, *FLASH_KERNELS)
        for name, n in counts.items():
            self.launches[name] = self.launches.get(name, 0) + n
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = trainer.update_seconds
        ck = os.path.join(trainer.log_dir, "step_000003")
        files = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
        ck_gb = sum(os.path.getsize(os.path.join(ck, f)) for f in files) / 1e9
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        print(f"full fine-tune 1B: trainable {trainer.trainable_keys}, "
              f"{trainer.global_step} optimizer steps, step seconds "
              f"{[round(x, 3) for x in steps]} "
              f"({config.dataset.train.batch_size / steps[-1]:.2f} pairs/s "
              f"at the last step); peak memory {peak_gb:.2f} GB; checkpoint "
              f"{ck_gb:.2f} GB ({files}) written in "
              f"{timed.seconds['save_checkpoint']:.1f} s; step5.main "
              f"{wall:.1f} s with the 1B init; launches {counts}; card {smi}")
        micro = trainer.global_step
        want = {"flash_fwd": 48 * micro, "flash_bwd_dq": 24 * micro,
                "flash_bwd_dkv": 24 * micro}
        self.check(counts == want and micro == 3
                   and trainer.trainable_keys == ["language_model"],
                   f"full fine-tune launches {counts} == 48/24/24 x {micro} "
                   f"micro-steps (24 layers), trainable {trainer.trainable_keys}")
        meta = read_json(os.path.join(ck, "meta.json")) if files else {}
        self.check(files == ["lora.npz", "meta.json", "opt.npz"]
                   and meta.get("mode") == "full" and meta.get("step") == 3,
                   f"step_000003/ {files}, meta mode {meta.get('mode')} step "
                   f"{meta.get('step')}")
        loss = trainer.logged[0]["loss"] if trainer.logged else float("nan")
        trained = trainer.model.params
        base = {"model_path": None, "model_preset": "1b", "device": "cuda",
                "seed": config.experiment.seed}
        merged_model, _, _ = model_factory.get_model(Config.from_nested(
            {**base, "ckpt_path": ck}))
        got = dict(leaves(merged_model.params["language_model"]))
        want_t = dict(leaves(trained["language_model"]))
        same = set(got) == set(want_t) and all(
            torch.equal(got[k], want_t[k].detach()) for k in got)
        del merged_model, got
        initial, _, _ = model_factory.get_model(Config.from_nested(base))
        init_lm = dict(leaves(initial.params["language_model"]))
        moved = sum(int((init_lm[k] != want_t[k].detach()).sum())
                    for k in init_lm)
        total = sum(t.numel() for t in init_lm.values())
        codebook = torch.equal(initial.params["gen_vision_model"]["codebook"],
                               trained["gen_vision_model"]["codebook"])
        print(f"full fine-tune 1B: {moved} of {total} language-model elements "
              f"({100 * moved / total:.2f}%) moved off their bf16 init in 3 "
              f"steps at lr 4e-5")
        self.check(same and codebook and moved > 0 and np.isfinite(loss),
                   f"get_model(ckpt_path) language model bit-equal to the "
                   f"trained one: {same}; codebook bit-equal to the initial "
                   f"one: {codebook}; loss {loss:.4f} finite, weights moved")
        del initial, init_lm, want_t, trained, trainer

    # -- phases 12 and 14c -------------------------------------------------
    def trunk_path(self, mode: str):
        """Step 5 at the 7B width with ``quantize_base: mode`` (module
        docstring, phases 12 and 14c)."""
        import gc

        import numpy as np

        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.ops import quant
        from ospo_tpu_torch.pipeline import step5

        gc.collect()  # the previous phase's model goes first
        torch.cuda.empty_cache()
        data_path = os.path.join(self.workdir, "step4", "train.json")
        config = Config.from_nested(merged(merged(STEP5_CONFIG, step5_overrides(
            data_path, os.path.join(self.workdir, "step3"),
            os.path.join(self.workdir, f"step5_{mode}"))),
            {"experiment": {"quantize_base": mode}}))
        torch.cuda.reset_peak_memory_stats()
        n0 = kernel_launches()
        t0 = time.time()
        trainer = step5.main(config)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launched(n0, *FLASH_KERNELS)
        for name, n in counts.items():
            self.launches[name] = self.launches.get(name, 0) + n
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = trainer.update_seconds
        self.trunks[mode] = {"steps": steps, "peak_gb": peak_gb}
        ref = self.lora_train
        int8 = self.trunks.get("int8", {}) if mode != "int8" else {}
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        print(f"step 5 {mode} trunk 7B: step seconds "
              f"{[round(x, 3) for x in steps]} (phase 5, bf16 trunk: "
              f"{[round(x, 3) for x in ref.get('steps', [])]}"
              + (f"; phase 12, int8 trunk: "
                 f"{[round(x, 3) for x in int8.get('steps', [])]}" if int8 else "")
              + f"); peak memory {peak_gb:.2f} GB (phase 5: "
              f"{ref.get('peak_gb', float('nan')):.2f} GB"
              + (f"; phase 12: {int8.get('peak_gb', float('nan')):.2f} GB"
                 if int8 else "")
              + f"); step5.main {wall:.1f} s; launches {counts}; card {smi}")
        layers = trainer.model.params["language_model"]["layers"]
        keys = {"q", "sa"} if mode == "w8a8" else {"q", "s"}
        quantized = all(isinstance(layers[n], dict) and set(layers[n]) == keys
                        and layers[n]["q"].dtype == torch.int8
                        for n in quant.QUANTIZABLE)
        micro = trainer.global_step
        want = {"flash_fwd": 60 * micro, "flash_bwd_dq": 30 * micro,
                "flash_bwd_dkv": 30 * micro}
        self.check(quantized and counts == want and micro == 3,
                   f"{mode} trunk: the 7 projections are {sorted(keys)} dicts "
                   f"({quantized}); launches {counts} == 60/30/30 x {micro} "
                   f"micro-steps")
        ck = os.path.join(trainer.log_dir, "step_000003")
        files = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
        meta = read_json(os.path.join(ck, "meta.json")) if files else {}
        loss = trainer.logged[0]["loss"] if trainer.logged else float("nan")
        moved = all(bool(ab["b"].abs().max() > 0)
                    for ab in trainer.trainable.values())
        self.check(files == ["lora.npz", "meta.json", "opt.npz"]
                   and meta.get("mode") == "lora" and np.isfinite(loss) and moved,
                   f"{mode} trunk: step_000003/ {files}, meta mode "
                   f"{meta.get('mode')}, loss {loss:.4f} finite, B moved off zero")
        del trainer

    # -- phase 13 --------------------------------------------------------
    def decode_modes_path(self):
        """Step 3's opt-in decode modes at the 7B width (module docstring,
        phase 13)."""
        import dataclasses

        import numpy as np

        from ospo_tpu_torch.engine.image_engine import ImageGenEngine
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.models import janus, llama
        from ospo_tpu_torch.ops import decode_attention as da
        from ospo_tpu_torch.processing import t2i_prompt

        layers, n_img = 30, 576
        base = {"kv_layout": "bshd", "kv_quant": "int8", "decode_segments": 8}
        plain = {"decode_attention": 0, "int4_matmul_row": 0,
                 "int4_matmul_group": 0}

        def plain_counts(tag, counts):
            self.check(counts == {"flash_fwd": layers, **plain},
                       f"step 3 {tag}: launches {counts} == flash_fwd {layers}"
                       f" (the prefill) and no decode kernel (plain read)")

        a = self.step3_group("bshd", base, DECODE_MODE_ITEMS)
        plain_counts("bshd", a["counts"])
        # the plain read against the decode kernel: teacher-forced CFG
        # logits of a bshd engine and of the shbd engine (the kernel) on
        # the same model, prompts and forced tokens (PROBE_TOKENS: two
        # segments of growing windows)
        eng = a.pop("engine")
        model, proc = eng.model, eng.processor
        del eng
        prompts = [t2i_prompt(proc, s["long_prompt"][0])
                   for s in read_json(FIXTURE)[:PROBE_PROMPTS]]
        forced = torch.randint(0, model.cfg.image_token_size,
                               (len(prompts), PROBE_TOKENS),
                               generator=torch.Generator().manual_seed(0)).numpy()

        def probe(m, layout, plain_kernel=False):
            """Forced logits of ``layout``'s engine on model ``m`` → (logits,
            decode-kernel launches); ``plain_kernel`` swaps the kernel's
            plain version in (the control)."""
            eng = ImageGenEngine(m, proc, image_token_num=PROBE_TOKENS,
                                 img_size=m.cfg.gen_image_size,
                                 patch_size=m.cfg.vq.downsample_factor,
                                 kv_quant="int8", decode_segments=8,
                                 kv_layout=layout)
            n0, kernel = kernel_launches(), llama.decode_attention
            if plain_kernel:
                llama.decode_attention = da.decode_attention_plain
                # the plain version reads a host cur_len: the eager loop,
                # not the trunk graph, whose step holds the length on the
                # device
                eng._replays_trunk = lambda: False
            try:
                out = eng.forced_cfg_logits(prompts, forced)
            finally:
                llama.decode_attention = kernel
            return out, launched(n0)["decode_attention"]

        def dist(x, ref):
            return float(np.abs(x - ref).max()), float(np.abs(ref).max())

        # in fp32 (7B width and depth, int8 weights, fp32 activations and
        # queries): the two reads differ by the order of fp32 sums
        f32_cfg = dataclasses.replace(
            model.cfg, dtype=torch.float32,
            language=dataclasses.replace(model.cfg.language, dtype=torch.float32))
        f32 = janus.JanusModel.init(f32_cfg, seed=1, quantize="int8",
                                    device=model.device, lm_head=False,
                                    understanding=False)
        ref, n_kernel = probe(f32, "shbd")
        got, n_plain = probe(f32, "bshd")
        del f32
        err, scale = dist(got, ref)
        self.check(err <= 1e-2 * scale and np.isfinite(got).all()
                   and n_kernel == layers * (PROBE_TOKENS - 1) and n_plain == 0,
                   f"bshd plain read vs shbd decode kernel, forced CFG logits "
                   f"(7B, int8 weights and KV, fp32 activations, "
                   f"{len(prompts)} prompts, {PROBE_TOKENS} tokens): max|d|="
                   f"{err:.3g}, max|ref|={scale:.3g} (tol 1e-2 max|ref|, phase "
                   f"3's); decode launches {n_kernel} (shbd) and {n_plain} "
                   f"(bshd)")
        # on (a)'s bf16 model the same comparison reads bf16 rounding that
        # 30 layers and PROBE_TOKENS - 1 steps carry forward; the kernel
        # against its own plain version is the control for that noise
        ref, _ = probe(model, "shbd")
        got, _ = probe(model, "bshd")
        ctl, _ = probe(model, "shbd", plain_kernel=True)
        del model
        err, scale = dist(got, ref)
        err_ctl, _ = dist(ctl, ref)
        print(f"bf16 forced CFG logits (7B, {len(prompts)} prompts, "
              f"{PROBE_TOKENS} tokens): bshd plain read vs shbd decode kernel "
              f"max|d|={err:.3g}; the kernel's plain version vs the kernel "
              f"max|d|={err_ctl:.3g}; max|ref|={scale:.3g}")
        self.check(np.isfinite(got).all() and np.isfinite(ctl).all()
                   and err <= 2 * err_ctl,
                   f"bf16 forced CFG logits finite (bshd and the control), "
                   f"bshd plain read within twice the control's distance "
                   f"from the kernel: {err:.3g} <= 2 x {err_ctl:.3g}")

        b = self.step3_group("bshd sjd4", {**base, "speculative": 4},
                             DECODE_MODE_ITEMS)
        plain_counts("bshd sjd4", b["counts"])
        iters = b.pop("engine").last_sjd_iters
        per_iter = (n_img - 1) / iters if iters else float("nan")
        print(f"step 3 bshd sjd4: last_sjd_iters {iters}, "
              f"{per_iter:.3f} tokens an iteration (the bootstrap token "
              f"comes from the prefill); {b['rate']:.1f} img-tok/s against "
              f"{a['rate']:.1f} sequential")
        self.check(iters is not None and 1 <= iters <= n_img - 1,
                   f"SJD: {iters} Jacobi iterations for {n_img - 1} tokens "
                   f"(never more than sequential)")

        c = self.step3_group("bshd int4 kv", {**base, "kv_quant": "int4"},
                             DECODE_MODE_ITEMS)
        plain_counts("bshd int4 kv", c["counts"])
        cache_gb = {}
        for tag, run in (("int8", a), ("int4", c)):
            kv = llama.init_kv_cache(
                janus.JANUS_PRO_7B.language, 2 * DECODE_MODE_ITEMS, 384 + n_img,
                quantized=tag, layout="bshd", device="meta")
            cache_gb[tag] = sum(t.numel() * t.element_size()
                                for t in kv.values() if torch.is_tensor(t)) / 1e9
        c.pop("engine")
        print(f"step 3 bshd: peak memory of token generation int4 KV "
              f"{c['tokens_gb']:.2f} GB, int8 KV {a['tokens_gb']:.2f} GB "
              f"(a cache of {2 * DECODE_MODE_ITEMS} rows x {384 + n_img}: int4 "
              f"{cache_gb['int4']:.2f}"
              f" GB, int8 {cache_gb['int8']:.2f} GB); whole run {c['peak_gb']:.2f}"
              f" and {a['peak_gb']:.2f} GB; {c['rate']:.1f} against "
              f"{a['rate']:.1f} img-tok/s")

    # -- phase 14b -------------------------------------------------------
    def w8a8_score_path(self):
        """Step 4b at the 7B width on a w8a8 trunk, readout off and on
        (module docstring, phase 14b)."""
        import gc

        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.engine.scoring import ScoringEngine
        from ospo_tpu_torch.ops import quant
        from ospo_tpu_torch.pipeline import step4
        from ospo_tpu_torch.pipeline.model_factory import get_model

        gc.collect()  # the previous phase's model goes first
        torch.cuda.empty_cache()
        items = score_items()[:W8A8_SCORE_ITEMS]
        save = os.path.join(self.workdir, "step4b_w8a8")
        os.makedirs(save)
        config = Config.from_nested({
            **STEP4_CONFIG, "model_path": None, "model_preset": "7b",
            "quantize": "w8a8", "image_path": os.path.join(self.workdir, "step3"),
            "save_path": save})
        torch.cuda.reset_peak_memory_stats()
        model, _, processor = get_model(config)
        layers = model.params["language_model"]["layers"]
        self.check(all(set(layers[n]) == {"q", "sa"} for n in quant.QUANTIZABLE),
                   "step 4b w8a8: the trunk's 7 projections are {q, sa} dicts")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        scored = step4.score_prepared_chunk
        answers = {}
        for readout in (False, True):
            seen = {}

            def keep(engine, chunk):
                out = scored(engine, chunk)
                for job, res in zip(chunk["jobs"], out):
                    if res is not None:
                        seen[job["path"]] = [a["answer"]
                                             for a in res["answer_metadata"]]
                return out

            engine = ScoringEngine(model, processor,
                                   kv_quant=config.get("score_kv_quant") or False)
            engine.readout_w8a16 = readout
            n0 = kernel_launches()
            step4.score_prepared_chunk = keep
            try:
                with _ScoreRecorder(step4) as rec:
                    pairs, summary = step4.run_scoring(config, engine, items)
            finally:
                step4.score_prepared_chunk = scored
            st = rec.summary()
            n_flash = launched(n0)["flash_fwd"]
            self.launches["flash_fwd"] = self.launches.get("flash_fwd", 0) + n_flash
            n_images = sum(c["images"] for c in summary.values())
            answers[readout] = seen
            print(f"step 4b w8a8, readout {'W8A16' if readout else 'w8a8'}: "
                  f"{n_images} images in {st['loop_s']:.2f} s of the scoring "
                  f"loop ({n_images / st['loop_s']:.2f} images/s); "
                  f"{st['slices']} slices of {st['rows']} images, per slice "
                  f"prefill {st['prefill_ms']:.2f} ms, suffixes "
                  f"{st['suffix_ms']:.2f} ms; flash launches {n_flash}; "
                  f"engine counts {st['counts']}; {len(pairs)} pairs; card {smi}")
            self.check(n_images == 6 * W8A8_SCORE_ITEMS and len(seen) == n_images
                       and all(c["scored"] == c["images"] for c in summary.values())
                       and st["counts"] == {"oom_retries": 0, "unshared_calls": 0,
                                            "per_image_retries": 0}
                       and n_flash == 30 * st["slices"],
                       f"step 4b w8a8 (readout {readout}): {n_images} images "
                       f"scored, no retry or fallback {st['counts']}, flash "
                       f"launches {n_flash} == 30 x {st['slices']} slices")
        keys = [(p, i) for p, a in answers[False].items() for i in range(len(a))]
        same = sum(answers[False][p][i] == answers[True].get(p, [None] * (i + 1))[i]
                   for p, i in keys)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"step 4b w8a8: the two readouts agree on {same} of {len(keys)} "
              f"yes/no answers ({same / max(1, len(keys)):.4f}); peak memory "
              f"{peak_gb:.2f} GB")
        self.check(len(keys) > 0, f"step 4b w8a8: {len(keys)} answers compared")
        del model

    # -- phase 15 --------------------------------------------------------
    def start_synthetic_write(self):
        """Start 15a's writer in a process of its own (no card), so that its
        host draws overlap the card-bound phases instead of adding to the
        script's time; 15a waits for it."""
        free_gb = shutil.disk_usage(self.workdir).free / 1e9
        self.check(free_gb >= SYNTH_FREE_GB,
                   f"{free_gb:.1f} GB free under the temp directory for the 1B "
                   f"directory and its runs (needs {SYNTH_FREE_GB} GB)")
        path = os.path.join(self.workdir, "janus_pro_1b")
        code = ("import json, sys, time\n"
                f"sys.path.insert(0, {ROOT!r})\n"
                "from ospo_tpu_torch.models import janus, synthetic\n"
                "t0 = time.time()\n"
                f"synthetic.write_synthetic_checkpoint({path!r}, "
                f"janus.JANUS_PRO_1B, seed={SYNTH_SEED})\n"
                "print(json.dumps({'seconds': time.time() - t0}))\n")
        log = os.path.join(self.workdir, "synthetic_write.log")
        with open(log, "w") as f:
            proc = subprocess.Popen([sys.executable, "-c", code], stdout=f,
                                    stderr=subprocess.STDOUT,
                                    env=dict(os.environ,
                                             CUDA_VISIBLE_DEVICES=""))
        self.writer = {"proc": proc, "path": path, "log": log,
                       "t0": time.time()}
        print(f"synthetic 1B directory: writer started (pid {proc.pid})")

    # -- phase 2: the MoE kernels ----------------------------------------
    def moe_kernels(self):
        """``ops/moe.py``'s five kernels (``routed_experts`` on card tensors)
        against the plain functions on the same card tensors, at
        DeepSeek-V2-Lite's widths (64 routed experts, top-6, 2 shared, D
        2048, F 1408): a decode step's 48 tokens (tiles of 16) and a
        prefill bucket's 48 x 64 (tiles of 64).  Routing (``moe_route``):
        ``route_plain``'s experts but where a token's k-th and next scores
        tie to fp32 rounding (a chosen expert at most 1e-6 below the plain
        k-th score, at most 1 token in 500 differing), weights within 1e-5.
        Grouping and GEMMs, with the kernels' own routing handed to the plain
        version: the same counts, the output within bf16 rounding of each
        stage (2^-7 |ref| + 1e-2 max|ref|: the products are exact in fp32 on
        both sides, only the order of the sums differs), and two controls
        outside that tolerance: one routed slot dropped (weight 0) and the
        down scales of one expert read from the next.  Times: CUDA-graph
        replay of 10 calls, every call reading its 553.6 MB of routed-expert
        rows from device memory."""
        from ospo_tpu_torch.ops import moe
        from ospo_tpu_torch.ops.quant import quantize_matrix

        dev = torch.device("cuda")
        E, S, D, F, k = 64, 2, 2048, 1408, 6
        g = torch.Generator(device=dev).manual_seed(3)
        w13 = quantize_matrix((torch.randn((E + S, 2 * F, D), generator=g, device=dev)
                               * D ** -0.5).to(torch.bfloat16))
        w2 = quantize_matrix((torch.randn((E + S, D, F), generator=g, device=dev)
                              * F ** -0.5).to(torch.bfloat16))
        router = (torch.randn((E, D), generator=g, device=dev) * D ** -0.5).to(torch.bfloat16)

        def plain(x, ti, tw, w2p=w2):
            bm = moe.block_m(ti.numel(), E + S)
            c, off, src, te, ts = moe.align_plain(ti, E + S, bm)
            h = moe.gate_up_plain(x, src, off, te, ts, w13, k + S, bm)
            y = moe.down_plain(h, src, off, te, ts, w2p, bm)
            return moe.combine_plain(y, tw, x.dtype), c

        def within(got, want):
            gf, wf = got.float(), want.float()
            tol = 2 ** -7 * wf.abs() + 1e-2 * float(wf.abs().max())
            return bool(((gf - wf).abs() <= tol).all()), max_err(gf, wf)

        names = ("moe_route", "moe_align", "moe_gate_up", "moe_down", "moe_combine")
        for n_tok, what in ((48, "decode"), (48 * 64, "prefill")):
            x = (torch.randn((n_tok, D), generator=g, device=dev)).to(torch.bfloat16)
            counts = torch.zeros(E + S, dtype=torch.int32, device=dev)
            n0 = kernel_launches()
            got = moe.routed_experts(x, router, w13, w2, k, counts, n_shared=S)
            torch.cuda.synchronize()
            moved = all(n == 1 for n in launched(n0, *names).values())
            ti, tw = moe.route(x, router, k, n_shared=S)
            differ, shortfall, w_err = moe.routing_gap(x, router, ti, tw, k)
            want, c = plain(x, ti, tw)
            ok, err = within(got, want)
            self.check(moved and differ <= n_tok // 500 and shortfall <= 1e-6
                       and w_err <= 1e-5 and torch.equal(counts, c) and ok,
                       f"moe kernels {what} ({n_tok} tokens, {n_tok * (k + S)} rows): "
                       f"each kernel launched once {moved}; routing: {differ} tokens "
                       f"differ (at most {n_tok // 500}), shortfall {shortfall:.3g} (tol "
                       f"1e-6), weights max|d| {w_err:.3g} (tol 1e-5); counts equal "
                       f"{torch.equal(counts, c)}, output max|d| {err:.3g} of max|ref| "
                       f"{float(want.float().abs().max()):.3g} (tol 2^-7|ref| + "
                       f"1e-2 max|ref|)")
            dropped = tw.clone()
            dropped[:, 0] = 0
            shifted = {"q": w2["q"], "s": torch.roll(w2["s"], 1, dims=0)}
            for name, ctl in (("a routed slot dropped", plain(x, ti, dropped)[0]),
                              ("one expert's down scales read from the next",
                               plain(x, ti, tw, shifted)[0])):
                ctl_ok, ctl_err = within(ctl, want)
                self.check(not ctl_ok, f"moe {what} control, {name}: max|d| "
                                       f"{ctl_err:.3g}, outside the tolerance")
            if what == "decode":
                ms = cuda_ms_graph([lambda: moe.routed_experts(
                    x, router, w13, w2, k, counts, n_shared=S)], 10)
                plain_ms = cuda_ms(lambda: plain(x, *moe.with_shared(
                    *moe.route_plain(x, router, k), E, S)), 3, 1)
                touched = int((c > 0).sum())
                nbytes = touched * (3 * D * F + 4 * (2 * F + D))
                flops = 2 * n_tok * (k + S) * 3 * D * F
                bound_ms = max(nbytes / PEAK_BYTES, flops / PEAK_BF16) * 1e3
                print(f"moe kernels, one layer at 48 tokens: {ms:.4f} ms (graph "
                      f"replay, cold), plain {plain_ms:.3f} ms (it walks the tile table "
                      f"on the host), bound {bound_ms:.4f} ms (bytes: {touched} "
                      f"experts, {nbytes / 1e6:.1f} MB)")
                self.kernels["moe_experts"] = {
                    "name": "moe_experts", "route": "cuda",
                    "source": "ospo_tpu_torch/ops/csrc/moe_experts.cu",
                    "replaces": None, "launches": None, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                    "library_ms": None,
                    "library_note": "no PyTorch call computes grouped W8A16 experts"}
            del x, got, want

    def gdn_kernel(self):
        """``ops/gated_delta.py``'s ``gdn_decode`` (``decode`` on card
        tensors) against ``decode_plain`` on copies of the same tensors, at
        the Qwen3-Next cell's shapes: 192 rows, 16 key and 32 value heads of
        128, a conv of width 4, one T = 1 step from a state of 8 earlier
        plain steps.  The state within 1e-5 of the plain one (relative
        Frobenius distance, a row and value head: both keep it in fp32, only
        the order of the sums differs), the conv state equal, the output
        within one bf16 rounding; the plain state rounded to bf16 (a
        control) outside the state's tolerance.  Time: CUDA-graph replay,
        every call reading its 403 MB state from device memory, against the
        bytes' bound (``benchmark/roofline/gated_delta.py``'s count)."""
        from ospo_tpu_torch.ops import gated_delta as gd

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(5)
        R, hk, hv, dk, K, eps = 192, 16, 32, 128, 4, 1e-6
        C = 2 * hk * dk + hv * dk
        bf = dict(dtype=torch.bfloat16, device=dev)

        def randn(*shape, std=1.0):
            return torch.randn(shape, generator=g, device=dev) * std

        conv_w = randn(C, K, std=0.5).to(torch.bfloat16)
        a_log = torch.log(1 + 15 * torch.rand((hv,), generator=g, device=dev))
        dt_bias = randn(hv, std=0.5) - 4.0
        norm_w = 1 + randn(dk, std=0.1)
        conv_state = torch.zeros((R, K - 1, C), **bf)
        state = torch.zeros((R, hv, dk, dk), dtype=torch.float32, device=dev)
        args = (a_log, dt_bias, norm_w, hk, dk, dk, hv // hk, eps)

        def inputs():
            return (randn(R, hk * (2 * dk + 4 * dk)).to(torch.bfloat16),
                    randn(R, 4 * hk).to(torch.bfloat16))

        for _ in range(8):
            gd.decode_plain(*inputs(), conv_w, conv_state, state, *args)
        qkvz, ba = inputs()
        cs_k, st_k = conv_state.clone(), state.clone()
        n0 = kernel_launches()
        out = gd.decode(qkvz, ba, conv_w, cs_k, st_k, *args)
        torch.cuda.synchronize()
        once = launched(n0, "gdn_decode")["gdn_decode"] == 1
        cs_p, st_p = conv_state.clone(), state.clone()
        want = gd.decode_plain(qkvz, ba, conv_w, cs_p, st_p, *args)

        def rel(a, b):
            return float(((a - b).pow(2).sum((-2, -1))
                          / b.pow(2).sum((-2, -1))).sqrt().max())

        err_state, err_ctl = rel(st_k, st_p), rel(st_p.to(torch.bfloat16).float(), st_p)
        wf = want.float()
        out_ok = bool(((out.float() - wf).abs()
                       <= 2 ** -7 * wf.abs() + 1e-3 * float(wf.abs().max())).all())
        self.check(once and err_state <= 1e-5 and torch.equal(cs_k, cs_p) and out_ok
                   and err_ctl > 1e-5,
                   f"gdn_decode at {R} rows, {hk}/{hv} heads of {dk}: launched once "
                   f"{once}; state distance {err_state:.3g} (tol 1e-5), conv state equal "
                   f"{torch.equal(cs_k, cs_p)}, output within one bf16 rounding {out_ok} "
                   f"(max|d| {max_err(out, want):.3g}); control, the state in bf16: "
                   f"{err_ctl:.3g}, outside the tolerance")
        ms = cuda_ms_graph([lambda: gd.decode(qkvz, ba, conv_w, cs_k, st_k, *args)], 10)
        plain_ms = cuda_ms(lambda: gd.decode_plain(qkvz, ba, conv_w, cs_p, st_p, *args), 3, 1)
        channels, state_b = C, R * hv * dk * dk * 4
        nbytes = (2 * state_b + 2 * R * (K - 1) * channels * 2
                  + R * (channels + hv * dk + 2 * hv) * 2 + channels * K * 2
                  + 2 * hv * 4 + dk * 4 + R * hv * dk * 2)
        bound_ms = nbytes / PEAK_BYTES * 1e3
        print(f"gdn_decode, one layer at {R} rows: {ms:.4f} ms (graph replay, cold; "
              f"{100 * bound_ms / ms:.1f}% of bound), plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms (bytes: {nbytes / 1e6:.1f} MB)")
        self.kernels["gdn_decode"] = {
            "name": "gdn_decode", "route": "cuda",
            "source": "ospo_tpu_torch/ops/csrc/gated_delta.cu",
            "replaces": None, "launches": None, "max_abs_err": max_err(out, want),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None,
            "library_note": "no PyTorch call computes a gated delta-rule step"}

    def kda_kernel(self):
        """``ops/gated_delta.py``'s ``kda_decode`` (``kda_decode`` on card
        tensors) against ``kda_decode_plain`` on copies of the same tensors,
        at the Kimi Linear cell's shapes: 192 rows, 32 heads of 128, a conv
        of width 4, one T = 1 step from a state of 8 earlier plain steps.
        The state within 1e-5 of the plain one (relative Frobenius distance,
        a row and head), the conv state equal, the output within one bf16
        rounding; the plain state rounded to bf16 (a control) outside the
        state's tolerance.  Time: CUDA-graph replay, every call reading its
        403 MB state from device memory, against the bytes' bound
        (``benchmark/roofline/kda.py``'s count)."""
        from ospo_tpu_torch.ops import gated_delta as gd

        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(6)
        R, H, D, K, eps = 192, 32, 128, 4, 1e-5
        width = H * D
        bf = dict(dtype=torch.bfloat16, device=dev)

        def randn(*shape, std=1.0):
            return torch.randn(shape, generator=g, device=dev) * std

        conv_w = randn(3 * width, K, std=0.5).to(torch.bfloat16)
        a_log = torch.log(1 + 15 * torch.rand((H,), generator=g, device=dev))
        dt_bias = randn(width, std=0.5) - 4.0
        norm_w = 1 + randn(D, std=0.1)
        conv_state = torch.zeros((R, K - 1, 3 * width), **bf)
        state = torch.zeros((R, H, D, D), dtype=torch.float32, device=dev)
        args = (a_log, dt_bias, norm_w, H, eps)

        def inputs():
            xs = [randn(R, width).to(torch.bfloat16) for _ in range(5)]
            return (*xs[:4], randn(R, H).to(torch.bfloat16), xs[4])

        for _ in range(8):
            gd.kda_decode_plain(*inputs(), conv_w, conv_state, state, *args)
        xs = inputs()
        cs_k, st_k = conv_state.clone(), state.clone()
        n0 = kernel_launches()
        out = gd.kda_decode(*xs, conv_w, cs_k, st_k, *args)
        torch.cuda.synchronize()
        once = launched(n0, "kda_decode")["kda_decode"] == 1
        cs_p, st_p = conv_state.clone(), state.clone()
        want = gd.kda_decode_plain(*xs, conv_w, cs_p, st_p, *args)

        def rel(a, b):
            return float(((a - b).pow(2).sum((-2, -1))
                          / b.pow(2).sum((-2, -1))).sqrt().max())

        err_state, err_ctl = rel(st_k, st_p), rel(st_p.to(torch.bfloat16).float(), st_p)
        wf = want.float()
        out_ok = bool(((out.float() - wf).abs()
                       <= 2 ** -7 * wf.abs() + 1e-3 * float(wf.abs().max())).all())
        self.check(once and err_state <= 1e-5 and torch.equal(cs_k, cs_p) and out_ok
                   and err_ctl > 1e-5,
                   f"kda_decode at {R} rows, {H} heads of {D}: launched once {once}; state "
                   f"distance {err_state:.3g} (tol 1e-5), conv state equal "
                   f"{torch.equal(cs_k, cs_p)}, output within one bf16 rounding {out_ok} "
                   f"(max|d| {max_err(out, want):.3g}); control, the state in bf16: "
                   f"{err_ctl:.3g}, outside the tolerance")
        ms = cuda_ms_graph([lambda: gd.kda_decode(*xs, conv_w, cs_k, st_k, *args)], 10)
        plain_ms = cuda_ms(lambda: gd.kda_decode_plain(*xs, conv_w, cs_p, st_p, *args), 3, 1)
        state_b = R * H * D * D * 4
        nbytes = (2 * state_b + 2 * R * (K - 1) * 3 * width * 2
                  + R * (3 * width + 2 * width + H) * 2 + 3 * width * K * 2
                  + H * 4 + width * 4 + D * 4 + R * width * 2)
        bound_ms = nbytes / PEAK_BYTES * 1e3
        print(f"kda_decode, one layer at {R} rows: {ms:.4f} ms (graph replay, cold; "
              f"{100 * bound_ms / ms:.1f}% of bound), plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.4f} ms (bytes: {nbytes / 1e6:.1f} MB)")
        self.kernels["kda_decode"] = {
            "name": "kda_decode", "route": "cuda",
            "source": "ospo_tpu_torch/ops/csrc/gated_delta.cu",
            "replaces": None, "launches": None, "max_abs_err": max_err(out, want),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None,
            "library_note": "no PyTorch call computes a delta-rule step with a "
                            "per-channel decay"}

    # -- phase 21 --------------------------------------------------------
    def kimi_step(self):
        """The Kimi Linear trunk through the image engine (module docstring,
        phase 21)."""
        import gc

        import numpy as np

        sys.path.insert(0, os.path.join(ROOT, "benchmark"))
        from harness.port import load_model, processor_for
        from harness.weights_kimi_linear import make_weights

        from ospo_tpu_torch.engine.image_engine import ImageGenEngine
        from ospo_tpu_torch.ops import moe

        gc.collect()  # the previous phase's model goes first
        torch.cuda.empty_cache()
        with open(os.path.join(ROOT, "benchmark", "configs",
                               "janus-kimi-linear-48b-a3b.json")) as f:
            cfg = json.load(f)
        dev = torch.device("cuda")
        t0 = time.time()
        weights = make_weights(cfg, ("language", "generation"), 4321, dev)
        model = load_model(cfg, weights, os.path.join(self.workdir, "kimi_linear"), dev,
                           quantize="int8")
        del weights
        gc.collect()
        torch.cuda.empty_cache()
        params, mc = model.params, model.cfg
        lc = mc.language
        print(f"kimi step: Kimi Linear trunk ({lc.num_layers} layers, {lc.n_kda} KDA, "
              f"{lc.n_mla} MLA, {lc.held} of {lc.experts} experts held) loaded and "
              f"quantized in {time.time() - t0:.1f} s")
        engine = ImageGenEngine(model, processor_for(model, cfg), image_token_num=8,
                                img_size=2 * mc.vq.downsample_factor,
                                patch_size=mc.vq.downsample_factor)
        prompts = [f"a photo of object {i}" for i in range(8)]
        forced = np.random.default_rng(7).integers(0, mc.image_token_size, (8, 8))
        engine.forced_cfg_logits(prompts, forced)           # capture
        t_prompt = engine.build_cfg_batch(prompts)[0].shape[1]
        n0 = kernel_launches()
        a = engine.forced_cfg_logits(prompts, forced)       # replays
        got = launched(n0)
        steps = engine.image_token_num - 1
        names = ("kda_decode", "moe_route", "moe_gate_up")
        want = {"kda_decode": lc.n_kda * (steps + t_prompt),
                "moe_route": lc.n_moe * engine.image_token_num,
                "moe_gate_up": lc.n_moe * engine.image_token_num}
        replayed = engine._graph is not None and engine._graph.graph is not None
        self.check(replayed and all(got[n] == want[n] for n in names)
                   and bool(np.isfinite(a).all()),
                   f"kimi step: {steps} replayed steps of {2 * len(prompts)} rows launch "
                   f"{ {n: got[n] for n in names} } (want {want}: {lc.n_kda} kda_decode a "
                   f"step and a prompt position), replayed {replayed}, logits finite")
        for name in names:
            self.launches[name] = self.launches.get(name, 0) + got[name]
        # moe_route's sigmoid mode at 256 experts top-8 on layer 1's router
        # and correction bias against the plain routing
        mp = params["language_model"]["moe"]
        router, bias = mp["router"][0], mp["bias"][0]
        g = torch.Generator(device=dev).manual_seed(8)
        x = torch.randn((192, lc.hidden_size), generator=g, device=dev).to(torch.bfloat16)
        k, s = lc.num_experts_per_tok, lc.routed_scaling_factor
        ti, tw = moe.route(x, router, k, True, s, score_bias=bias)
        differ, shortfall, w_err = moe.routing_gap(x, router, ti, tw, k, True, s, bias)
        self.check(differ <= 192 // 500 and shortfall <= 1e-6 and w_err <= 1e-5,
                   f"moe_route sigmoid at {lc.experts} experts top-{k} (192 tokens): "
                   f"{differ} tokens differ, shortfall {shortfall:.3g} (tol 1e-6), weights "
                   f"max|d| {w_err:.3g} (tol 1e-5)")
        del model, engine
        gc.collect()
        torch.cuda.empty_cache()

    # -- phase 20 --------------------------------------------------------
    def hybrid_step(self):
        """A step of the Qwen3-Next trunk (module docstring, phase 20)."""
        import gc

        sys.path.insert(0, os.path.join(ROOT, "benchmark"))
        from harness.port import load_model
        from harness.weights_qwen3_next import make_weights

        from ospo_tpu_torch.models import janus as janus_lib
        from ospo_tpu_torch.models import llama
        from ospo_tpu_torch.ops import moe

        gc.collect()  # the previous phase's model goes first
        torch.cuda.empty_cache()
        with open(os.path.join(ROOT, "benchmark", "configs",
                               "janus-qwen3-next-80b-a3b.json")) as f:
            cfg = json.load(f)
        dev = torch.device("cuda")
        t0 = time.time()
        weights = make_weights(cfg, ("language", "generation"), 1234, dev)
        model = load_model(cfg, weights, os.path.join(self.workdir, "qwen3_next"), dev,
                           quantize="int8")
        del weights
        gc.collect()
        torch.cuda.empty_cache()
        params, mc = model.params, model.cfg
        lc = mc.language
        print(f"hybrid step: Qwen3-Next trunk ({lc.num_layers} layers, {lc.n_gdn} GDN, "
              f"{lc.held} of {lc.experts} experts held) loaded and quantized in "
              f"{time.time() - t0:.1f} s")
        rows, t_prompt = 16, 32
        g = torch.Generator(device=dev).manual_seed(7)
        tokens = torch.randint(0, min(1000, lc.vocab_size), (rows, t_prompt), generator=g,
                               device=dev)
        mask = torch.ones((rows, t_prompt), dtype=torch.int32, device=dev)
        with torch.inference_mode():
            kv = janus_lib.init_kv_cache(params, mc, rows, t_prompt + 1, device=dev)
            _, kv = janus_lib.language_forward(
                params, mc, janus_lib.embed_text(params, tokens), mask,
                llama.positions_from_mask(mask), kv_cache=kv, self_attn=True)
            img = torch.randint(0, mc.image_token_size, (rows, 1), generator=g, device=dev)
            embeds = janus_lib.prepare_gen_img_embeds(params, mc, img)
            window = torch.ones((rows, t_prompt + 1), dtype=torch.int32, device=dev)
            pos = torch.full((rows, 1), t_prompt, dtype=torch.long, device=dev)
            torch.cuda.synchronize()
            n0 = kernel_launches()
            hidden, _ = janus_lib.language_forward(params, mc, embeds, window, pos,
                                                   kv_cache=kv)
            torch.cuda.synchronize()
            got = launched(n0)
        names = ("gdn_decode", "moe_route", "moe_align", "moe_gate_up", "moe_down",
                 "moe_combine")
        want = {"gdn_decode": lc.n_gdn, **{n: lc.n_moe for n in names[1:]}}
        self.check(all(got[n] == want[n] for n in names)
                   and bool(torch.isfinite(hidden.float()).all()),
                   f"hybrid step: one cached step of {rows} rows launches "
                   f"{ {n: got[n] for n in names} } (want {want}), hidden finite")
        for name in names:
            self.launches[name] = self.launches.get(name, 0) + got[name]
        # moe_route at 512 experts top-10, on the held range and with the
        # shared gate, against the plain routing of layer 0's router
        router = params["language_model"]["moe"]["router"][0]
        x = torch.randn((192, lc.hidden_size), generator=g, device=dev).to(torch.bfloat16)
        k, E = lc.num_experts_per_tok, lc.experts
        ti, tw = moe.route(x, router[:E].contiguous(), k, True)
        differ, shortfall, w_err = moe.routing_gap(x, router[:E], ti, tw, k, True)
        hi, hw = moe.route(x, router, k, True, 1.0, lc.n_shared, held=lc.held_range,
                           shared_gate=True)
        held_ok = torch.equal(hi[:, :k], moe.held_ids(ti, lc.held_range)) \
            and torch.equal(hw[:, :k], tw)
        gate = torch.sigmoid(x.float() @ router[E].float())
        gate_err = float((hw[:, k:] - gate[:, None]).abs().max())
        self.check(differ <= 192 // 500 and shortfall <= 1e-6 and w_err <= 1e-5
                   and held_ok and gate_err <= 1e-5,
                   f"moe_route at {E} experts top-{k} (192 tokens): {differ} tokens "
                   f"differ, shortfall {shortfall:.3g} (tol 1e-6), weights max|d| "
                   f"{w_err:.3g} (tol 1e-5); held range {lc.held_range} ids and weights "
                   f"the same slots' {held_ok}, shared gate max|d| {gate_err:.3g} "
                   f"(tol 1e-5)")
        del model, kv, hidden
        gc.collect()
        torch.cuda.empty_cache()

    # -- phase 19 --------------------------------------------------------
    def moe_path(self):
        """Step 3 on the MLA/MoE trunk (module docstring, phase 19)."""
        import gc

        sys.path.insert(0, os.path.join(ROOT, "benchmark"))
        from harness.port import load_model, processor_for
        from harness.weights_deepseek_v2 import make_weights

        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.engine.image_engine import ImageGenEngine
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.pipeline.step3 import run_step3
        from ospo_tpu_torch.utils import profiling
        from ospo_tpu_torch.utils.png import read_png

        gc.collect()  # the previous phase's model goes first
        torch.cuda.empty_cache()
        with open(os.path.join(ROOT, "benchmark", "configs",
                               "janus-deepseek-v2-lite.json")) as f:
            cfg = json.load(f)
        dev = torch.device("cuda")
        root = os.path.join(self.workdir, "step3_moe")
        t0 = time.time()
        weights = make_weights(cfg, ("language", "generation"), 1234, dev)
        model = load_model(cfg, weights, os.path.join(root, "model"), dev,
                           quantize="int8")
        del weights
        gc.collect()
        torch.cuda.empty_cache()
        mc = model.cfg
        lc = mc.language
        print(f"MoE path: DeepSeek-V2-Lite trunk ({lc.num_layers} layers, "
              f"{lc.n_moe} MoE, {lc.n_routed_experts} + {lc.n_shared_experts} experts) "
              f"loaded through load_janus and quantized in {time.time() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        proc = processor_for(model, cfg)
        engine = ImageGenEngine(model, proc, cfg_weight=5.0, temperature=1.0,
                                image_token_num=mc.num_gen_tokens,
                                img_size=mc.gen_image_size,
                                patch_size=mc.vq.downsample_factor, decode_segments=8,
                                batch_cap=N_ITEMS)
        items = read_json(FIXTURE)[:N_ITEMS]
        for sample in items:
            sample["long_prompt"] = [sample["long_prompt"][0], "", ""]
            sample["negative_long_prompt"] = ["", "", ""]
        names = ("moe_route", "moe_align", "moe_gate_up", "moe_down", "moe_combine")
        n0 = kernel_launches()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        stats = run_step3(Config.from_nested({"batch_size": N_ITEMS, "seed_list": [0, 1, 2],
                                              "save_path": os.path.join(root, "out")}),
                          engine, proc, items)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = launched(n0)
        steps = mc.num_gen_tokens            # the prefill and 575 cached steps
        want = lc.n_moe * steps
        self.check(all(launches[n] == want for n in names),
                   f"MoE path: each MoE kernel launched {lc.n_moe} x {steps} = {want} "
                   f"times (prefill and cached steps, replays counted): "
                   f"{ {n: launches[n] for n in names} }")
        for name in names:
            self.launches[name] = self.launches.get(name, 0) + launches[name]
        self.launches["moe_experts"] = self.launches.get("moe_experts", 0) + sum(
            launches[n] for n in names[:4])
        # a cached step: each layer's q with the latent projection, and o; the
        # dense layers' gate and up, and down (the prefill keeps its form)
        dense = lc.num_layers - lc.n_moe
        want = (2 * lc.num_layers + 2 * dense) * (steps - 1)
        self.check(launches["w8a16_matmul"] == want,
                   f"MoE path: w8a16_matmul launched {launches['w8a16_matmul']} == "
                   f"(2 x {lc.num_layers} + 2 x {dense}) x {steps - 1} times (replays "
                   "counted)")
        self.launches["w8a16_matmul"] = (self.launches.get("w8a16_matmul", 0)
                                         + launches["w8a16_matmul"])
        experts = [s for s in profiling.spans(t_run) if s.name == "image.experts"]
        routed = lc.n_moe * (steps - 1) * 2 * N_ITEMS * lc.num_experts_per_tok
        got = experts[-1].attrs if experts else {}
        self.check(len(experts) == 1 and got.get("routed_rows") == routed,
                   f"MoE path: one image.experts span, routed_rows "
                   f"{got.get('routed_rows')} == {routed}; idle experts "
                   f"{got.get('idle_experts')} of {got.get('expert_slots')}, busiest "
                   f"{got.get('busiest_rows')}")
        pngs = [os.path.join(root, "out", "base", s["category"], s["item_id"], "00.png")
                for s in items]
        real = [p for p in pngs if os.path.exists(p) and _real_png(read_png(p))]
        graphed = engine._graph is not None and engine._graph.graph is not None
        self.check(len(real) == N_ITEMS and graphed,
                   f"MoE path: {len(real)} of {N_ITEMS} real PNGs, the cached step "
                   f"replayed from a CUDA graph {graphed}")
        print(f"MoE path: one group of {N_ITEMS} CFG pairs in {wall:.2f} s "
              f"({N_ITEMS * steps / wall:.1f} img-tok/s), peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; run_step3 stats "
              f"{json.dumps(stats)[:300]}")
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()

    def close(self):
        """Stop what the script started and has not waited for."""
        proc = getattr(self, "writer", {}).get("proc")
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        proc = getattr(self, "gate", {}).get("proc")
        if proc is not None and proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()

    def synthetic_write(self):
        """15a: the port's writer, started before phase 11, has put a
        Janus-Pro-1B directory on disk."""
        from ospo_tpu_torch.models import janus, synthetic

        w = self.writer
        t0 = time.time()
        rc = w["proc"].wait(timeout=900)
        waited = time.time() - t0
        out = open(w["log"]).read()
        if rc != 0:
            print(f"--- writer output (last 6000 bytes) ---\n{out[-6000:]}")
        self.check(rc == 0, f"the writer process exits 0 (rc {rc})")
        seconds = json.loads(out.strip().splitlines()[-1])["seconds"]
        path = w["path"]
        shards = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
        gb = sum(os.path.getsize(os.path.join(path, f)) for f in shards) / 1e9
        n_params = sum(int(torch.Size(s).numel())
                       for _, s, _ in synthetic.janus_key_shapes(janus.JANUS_PRO_1B))
        print(f"synthetic Janus-Pro-1B directory: {len(shards)} shards, "
              f"{gb:.3f} GB ({n_params} bf16 parameters) written in "
              f"{seconds:.1f} s ({gb / seconds:.3f} GB/s) by its own process "
              f"beside phases 11 on; 15a waited {waited:.1f} s for it")
        self.check(abs(gb * 1e9 - 2 * n_params) < 1e6 * len(shards)
                   and os.path.exists(os.path.join(path, "config.json")),
                   f"the directory holds {gb:.3f} GB of shards (2 bytes x "
                   f"{n_params} parameters, and headers) and config.json")
        self.synth = {"path": path, "write_s": seconds, "gb": gb}

    def synthetic_load(self):
        """15b: ``get_model`` from the directory on the card beside the same
        preset's random init; a second ``load_janus`` bit-equal; sampled
        tensors equal to the writer's, recomputed on the host; the forced
        CFG probe finite."""
        import gc

        import numpy as np

        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.engine.image_engine import ImageGenEngine
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.models import janus, synthetic, weights
        from ospo_tpu_torch.pipeline.model_factory import get_model
        from ospo_tpu_torch.processing import t2i_prompt
        from ospo_tpu_torch.train.optim import leaves

        gc.collect()  # the previous phase's model goes first
        torch.cuda.empty_cache()
        path = self.synth["path"]

        def timed(cfg):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.time()
            model, _, proc = get_model(Config.from_nested(cfg))
            torch.cuda.synchronize()
            return (model, proc, time.time() - t0,
                    (torch.cuda.max_memory_allocated() - base) / 1e9)

        model, _, init_s, init_gb = timed({"model_preset": "1b",
                                           "seed": SYNTH_SEED})
        del model
        gc.collect()
        torch.cuda.empty_cache()
        model, proc, load_s, load_gb = timed({"model_path": path})
        print(f"1B set-up on the card: get_model from the directory "
              f"{load_s:.1f} s, peak {load_gb:.2f} GB ({self.synth['gb'] / load_s:.3f}"
              f" GB/s); random init of the preset {init_s:.1f} s, peak "
              f"{init_gb:.2f} GB")
        again = weights.load_janus(path, device="cuda", lm_head=True)
        first, second = leaves(model.params), leaves(again.params)
        same = [p for p, _ in first] == [p for p, _ in second] and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for (_, a), (_, b) in zip(first, second))
        self.check(same and len(first) > 100,
                   f"a second load_janus of the directory is bit-equal to "
                   f"get_model's ({len(first)} tensors)")
        del again, first, second
        lm = model.params["language_model"]
        sampled = {
            "language_model.model.embed_tokens.weight": lm["embed"],
            "language_model.model.layers.0.self_attn.q_proj.weight":
                lm["layers"]["wq"][0],
            "language_model.model.layers.0.mlp.gate_proj.weight":
                lm["layers"]["w_gate"][0],
            "language_model.model.layers.1.mlp.down_proj.weight":
                lm["layers"]["w_down"][1],
        }
        t0 = time.time()
        equal = {}
        for key, t in synthetic.synthetic_tensors(janus.JANUS_PRO_1B, SYNTH_SEED):
            if key in sampled:
                equal[key] = bool(torch.equal(sampled[key].cpu(), t))
                if len(equal) == len(sampled):
                    break
        self.check(len(equal) == 4 and all(equal.values()),
                   f"4 sampled tensors on the card equal the writer's values "
                   f"recomputed on the host from seed {SYNTH_SEED} "
                   f"({time.time() - t0:.1f} s): {equal}")
        prompts = [t2i_prompt(proc, s["long_prompt"][0])
                   for s in read_json(FIXTURE)[:PROBE_PROMPTS]]
        forced = torch.randint(0, model.cfg.image_token_size,
                               (len(prompts), PROBE_TOKENS),
                               generator=torch.Generator().manual_seed(0)).numpy()
        eng = ImageGenEngine(model, proc, image_token_num=PROBE_TOKENS,
                             img_size=model.cfg.gen_image_size,
                             patch_size=model.cfg.vq.downsample_factor,
                             kv_quant="int8", decode_segments=8)
        logits = eng.forced_cfg_logits(prompts, forced)
        self.check(np.isfinite(logits).all()
                   and logits.shape[:2] == (len(prompts), PROBE_TOKENS),
                   f"forced CFG logits of the loaded 1B model, {len(prompts)} "
                   f"prompts x {PROBE_TOKENS} tokens: shape {logits.shape}, "
                   f"finite, max|logit| {float(np.abs(logits).max()):.3g}")
        del model, eng

    def _launch(self, tag: str, nproc: int, module: str, args: list,
                timeout: float) -> dict:
        """``scripts/run_multihost_torch.sh nproc module args``; its output
        goes to ``<workdir>/<tag>.log``.  → the output, the wall seconds and
        each rank's ``# distributed runtime`` line and summary line."""
        import re

        env = dict(os.environ, PYTHON=sys.executable,
                   PYTHONPATH=os.pathsep.join([ROOT, os.environ.get(
                       "PYTHONPATH", "")]))
        log = os.path.join(self.workdir, f"{tag}.log")
        t0 = time.time()
        with open(log, "w") as f:
            proc = subprocess.Popen(
                ["bash", os.path.join(ROOT, "scripts", "run_multihost_torch.sh"),
                 str(nproc), module, *args], cwd=ROOT, env=env, stdout=f,
                stderr=subprocess.STDOUT, start_new_session=True)
            try:
                rc = proc.wait(timeout=timeout)
            finally:
                if proc.poll() is None:
                    os.killpg(proc.pid, 9)
                    proc.wait()
        wall = time.time() - t0
        out = open(log).read()
        # the ranks share one output, so read each record where it starts
        # and no further than it goes, whatever surrounds it
        runtime = dict(re.findall(
            r"# distributed runtime: process (\d+)/\d+ @ \S+ (backend \w+ "
            r"device (?:cuda:\d+|cpu))", out))
        decoder = json.JSONDecoder()
        summary = {int(m.group(1)): decoder.raw_decode(out, m.end())[0]
                   for m in re.finditer(r"# \w+ process (\d+)/\d+: ", out)}
        print(f"{tag}: {nproc} process(es), rc {rc}, {wall:.1f} s; "
              f"{ {int(k): v for k, v in runtime.items()} }")
        if rc != 0 or len(summary) != nproc:
            print(f"--- {tag} output (last 6000 bytes) ---\n{out[-6000:]}")
        self.check(rc == 0 and len(summary) == nproc,
                   f"{tag}: the launcher exits 0 and every rank reports")
        return {"out": out, "wall": wall, "runtime": runtime,
                "summary": summary}

    def synthetic_step3(self):
        """15c: step 3 from the 1B directory in two ranks on the one card
        (int8 weights): gloo, each (item, kind, seed) image exactly once,
        each rank's kernels launched."""
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.utils.png import read_png

        root = os.path.join(self.workdir, "dp_step3")
        os.makedirs(root)
        data = [   # an item a prompt: one group of 24 pairs a rank
            {**sample, "item_id": f"{sample['item_id']}{j}",
             "long_prompt": [prompt, "", ""],
             "negative_long_prompt": ["", "", ""]}
            for sample in read_json(FIXTURE)[:DP_STEP3_ITEMS // 3]
            for j, prompt in enumerate(sample["long_prompt"])]
        self.check(len(data) == DP_STEP3_ITEMS and all(
            s["long_prompt"][0] for s in data),
            f"{len(data)} one-prompt items (want {DP_STEP3_ITEMS})")
        data_path = os.path.join(root, "long_prompt.json")
        with open(data_path, "w") as f:
            json.dump(data, f)
        out = os.path.join(root, "out")
        run = self._launch("dp_step3", 2, "ospo_tpu_torch.pipeline.step3", [
            "--cfg_path", os.path.join(ROOT, "configs", "step3.yaml"),
            f"model_path={self.synth['path']}", f"data_path={data_path}",
            f"e_idx={DP_STEP3_ITEMS}", f"save_path={out}"], timeout=400)
        self.check(sorted(run["runtime"].values()) == [
            "backend gloo device cuda:0"] * 2,
            f"both ranks on the one card take gloo: {run['runtime']}")
        layers, steps = 24, 575
        per, rates, tokens, secs = DP_STEP3_ITEMS // 2, {}, 0, 0.0
        for rank, s in sorted(run["summary"].items()):
            n = s["launches"]
            rates[rank] = s["image_tokens"] / s["seconds"]
            tokens += s["image_tokens"]
            secs = max(secs, s["seconds"])
            for name in ("flash_fwd", "decode_attention"):
                self.launches[name] = self.launches.get(name, 0) + n[name]
            self.check(s["images"] == per and s["groups"] == 1
                       and n["flash_fwd"] == layers
                       and n["decode_attention"] == layers * steps,
                       f"step 3 rank {rank}: {s['images']} images in "
                       f"{s['groups']} group, launches flash_fwd "
                       f"{n['flash_fwd']} == {layers}, decode_attention "
                       f"{n['decode_attention']} == {layers} x {steps}")
        print(f"step 3, 1B from the directory, 2 ranks on one card, a group of "
              f"{per} CFG pairs a rank: img-tok/s "
              f"{ {r: round(v, 1) for r, v in rates.items()} } per rank, "
              f"{tokens / secs:.1f} for the pair ({tokens} image tokens over "
              f"the longer rank's {secs:.1f} s of serving); card {_smi()}")
        pngs = sorted(os.path.relpath(os.path.join(d, f), out)
                      for d, _, files in os.walk(out) for f in files
                      if f.endswith(".png"))
        want = sorted(os.path.join("base", s["category"], s["item_id"], "00.png")
                      for s in data)
        bad = [p for p in want if p in pngs and not _real_png(
            read_png(os.path.join(out, p)))]
        self.check(pngs == want and not bad,
                   f"step 3 tree: {len(pngs)} PNGs, each (item, kind, seed) "
                   f"of the {len(want)} asked for exactly once, real images "
                   f"(bad: {bad[:3]})")

    def synthetic_step5(self):
        """15d: step 5 (1B LoRA from the directory, global batch 16, 3
        optimizer steps, no gradient clip) in two ranks on the one card
        against one rank on NCCL over the same micro-batches (batch 8, 2
        accumulation steps)."""
        import numpy as np

        root = os.path.join(self.workdir, "dp_step5")
        os.makedirs(root)
        data_path = os.path.join(root, "train.json")
        records = train_records()[:DP_STEP5_BATCH]   # a batch an epoch
        self.check(len(records) == DP_STEP5_BATCH,
                   f"{len(records)} training records (want {DP_STEP5_BATCH})")
        with open(data_path, "w") as f:
            json.dump(records, f)
        # no clip: a clipped gradient hides its scale from the moments
        common = [
            "--cfg_path", os.path.join(ROOT, "configs", "step5.yaml"),
            f"model.model_path={self.synth['path']}",
            f"dataset.train.data_path={data_path}",
            f"image_root={os.path.join(self.workdir, 'step3')}",
            f"experiment.max_training_steps={DP_STEP5_STEPS}",
            f"experiment.max_epochs={DP_STEP5_STEPS}",
            "experiment.attn_impl=flash", "experiment.save_steps=1",
            "experiment.log_steps=1", "experiment.gradient_clip_val=null",
            "lora.lora_dropout=0"]
        half = DP_STEP5_BATCH // 2
        variants = {   # name → processes, batch, accumulation steps
            "two": (2, DP_STEP5_BATCH, 1), "one": (1, half, 2)}
        runs, layers = {}, 24
        for name, (n, batch, accum) in variants.items():
            runs[name] = self._launch(
                f"dp_step5_{name}", n, "ospo_tpu_torch.pipeline.step5",
                common + [f"model.data_parallel={n}",
                          f"dataset.train.batch_size={batch}",
                          f"experiment.gradient_accumulation_steps={accum}",
                          f"base.save_path={os.path.join(root, name)}"],
                timeout=400)
            for rank, st in sorted(runs[name]["summary"].items()):
                c = st["launches"]
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                    self.launches[k] = self.launches.get(k, 0) + c[k]
                micro = accum * DP_STEP5_STEPS
                want = {"flash_fwd": 2 * layers * micro,
                        "flash_bwd_dq": layers * micro,
                        "flash_bwd_dkv": layers * micro}
                got = {k: c[k] for k in want}
                print(f"step 5 {name} (processes {n}, batch {batch}, "
                      f"accumulation {accum}), rank {rank}: seconds a step "
                      f"{[round(x, 3) for x in st['update_seconds']]}")
                self.check(st["global_step"] == DP_STEP5_STEPS and got == want,
                           f"step 5 {name} rank {rank}: {st['global_step']} "
                           f"steps, launches {got} == {want}")
        self.check(sorted(runs["two"]["runtime"].values()) == [
            "backend gloo device cuda:0"] * 2
            and list(runs["one"]["runtime"].values())
            == ["backend nccl device cuda:0"],
            f"two ranks on one card take gloo, one rank NCCL: "
            f"{ {k: r['runtime'] for k, r in runs.items()} }")
        saved = [runs[k]["out"].count("# Saved checkpoint:") for k in runs]
        log = {k: os.path.join(root, k, "ospo") for k in runs}
        lines = len(open(os.path.join(log["two"], "scalars.jsonl")).readlines())
        self.check(saved[0] == saved[1] >= DP_STEP5_STEPS
                   and lines == DP_STEP5_STEPS,
                   f"two ranks: rank 0 alone wrote checkpoints ({saved[0]} "
                   f"times, as one rank {saved[1]}) and {lines} scalar lines")

        def distance(name, key_filter):
            """Per tensor of ``name`` in the two runs: (key, max|two -
            one|, max|one|)."""
            x, y = (np.load(os.path.join(log[r], name)) for r in ("two", "one"))
            return [(k, float(np.abs(x[k].astype(np.float64) - y[k]).max()),
                     float(np.abs(y[k].astype(np.float64)).max()))
                    for k in sorted(k for k in y.files if key_filter(k))]

        def held(rows, tol, what):
            w = max(rows, key=lambda r: r[1] / r[2] if r[2] else r[1])
            self.check(rows and all(d <= tol * sc for _, d, sc in rows),
                       f"step 5 {what}, two ranks vs one, per tensor within "
                       f"{tol:.3g} max|ref|: worst {w[0]} max|d| {w[1]:.3g} "
                       f"of max|ref| {w[2]:.3g}")

        # the first moment after step 1 is 0.1 x the unclipped mean gradient
        # of the global batch (A's is 0: B starts at zero); the two runs sum
        # the same micro-batch gradients, so they differ by the fp32
        # rounding of the mean alone
        held(distance("step_000001/opt.npz", lambda k: k.startswith("mu/")),
             2 ** -16, "gradient of step 1 (first moments)")
        final = f"step_{DP_STEP5_STEPS:06d}/lora.npz"
        for part in ("a", "b"):
            held(distance(final, lambda k: k.endswith("/" + part)), 2 ** -7,
                 f"final adapters {part.upper()}")
        # the first step builds the kernels' launch plans and allocator
        # pools; the mean of the later steps, over the ranks
        steps = {k: np.mean([np.mean(st["update_seconds"][1:]) for st in
                             runs[k]["summary"].values()]) for k in runs}
        print(f"step 5 1B LoRA, global batch {DP_STEP5_BATCH}: steps 2-"
              f"{DP_STEP5_STEPS} {steps['two']:.3f} s a step in two ranks on "
              f"one card, {steps['one']:.3f} s in one rank (two micro-batches "
              f"of {half}); card {_smi()}")

    # -- phase 16 --------------------------------------------------------
    def tp_path(self):
        """16: tensor parallel at the 1B width from phase 15's directory,
        tp = 2 in two ranks on the one card (gloo), each rank a
        ``chip_smoke --tp-worker`` process (:func:`tp_worker`) under
        ``scripts/run_multihost_torch.sh``; this process runs the same
        probes on the whole model and compares."""
        import gc

        import numpy as np

        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.engine.image_engine import ImageGenEngine
        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.models import llama
        from ospo_tpu_torch.ops import decode_attention as da
        from ospo_tpu_torch.pipeline import step4
        from ospo_tpu_torch.pipeline.model_factory import get_model
        from ospo_tpu_torch.utils.png import read_png

        gc.collect()
        torch.cuda.empty_cache()
        root = os.path.join(self.workdir, "tp")
        os.makedirs(os.path.join(root, "step4"))
        spec = tp_spec(root, self.synth["path"],
                       os.path.join(self.workdir, "step3"))
        with open(os.path.join(root, "step4", "vqa_prompt.json"), "w") as f:
            json.dump(score_items()[:TP_SCORE_ITEMS], f)
        run = self._launch("tp16", 2, "chip_smoke", ["--tp-worker", root],
                           timeout=900)
        self.check(sorted(run["runtime"].values()) == [
            "backend gloo device cuda:0"] * 2,
            f"both ranks on the one card take gloo: {run['runtime']}")
        ranks = [read_json(os.path.join(root, f"rank{r}.json"))
                 for r in range(2)]

        # (a) step 3: one group of TP_STEP3_ITEMS CFG pairs in each rank,
        # H = 8 of 16
        layers, steps = 24, 575
        rates = {}
        for rank, r in enumerate(ranks):
            st, n = r["step3"], r["step3"]["launches"]
            rates[rank] = st["image_tokens"] / st["seconds"]
            for name in ("flash_fwd", "decode_attention"):
                self.launches[name] = self.launches.get(name, 0) + n[name]
            self.check(st["images"] == TP_STEP3_ITEMS and st["groups"] == 1
                       and st["written"] == (TP_STEP3_ITEMS if rank == 0 else 0)
                       and n["flash_fwd"] == layers
                       and n["decode_attention"] == layers * steps
                       and r["cache_heads"] == [8],
                       f"tp step 3 rank {rank}: {st['images']} images in "
                       f"{st['groups']} group, {st['written']} written, "
                       f"launches flash_fwd {n['flash_fwd']} == {layers}, "
                       f"decode_attention {n['decode_attention']} == {layers} "
                       f"x {steps}, KV cache heads {r['cache_heads']} == [8]")
        tokens = ranks[0]["step3"]["image_tokens"]
        secs = max(r["step3"]["seconds"] for r in ranks)
        print(f"tp step 3, 1B from the directory, tp = 2 on one card (function, "
              f"not scaling), a group of {TP_STEP3_ITEMS} CFG pairs: img-tok/s "
              f"{ {r: round(v, 1) for r, v in rates.items()} } per rank, "
              f"{tokens / secs:.1f} for the pair ({tokens} image tokens over "
              f"the longer rank's {secs:.1f} s of serving); card {_smi()}")
        out = spec["step3"]["save_path"]
        pngs = sorted(os.path.relpath(os.path.join(d, f), out)
                      for d, _, files in os.walk(out) for f in files
                      if f.endswith(".png"))
        want = sorted(os.path.join("base", s["category"], s["item_id"], "00.png")
                      for s in read_json(spec["step3"]["data_path"]))
        bad = [p for p in want if p in pngs and not _real_png(
            read_png(os.path.join(out, p)))]
        self.check(pngs == want and not bad,
                   f"tp step 3 tree: {len(pngs)} PNGs, each of the {len(want)} "
                   f"asked for exactly once, real images (bad: {bad[:3]})")

        # the forced CFG probe: one process, the kernel and (the control)
        # its plain version, against the pair
        model, _, proc = get_model(Config.from_nested(spec["step3"]))
        prompts, forced = tp_probe_inputs(proc, model.cfg.image_token_size)
        eng = ImageGenEngine(model, proc, image_token_num=PROBE_TOKENS,
                             img_size=model.cfg.gen_image_size,
                             patch_size=model.cfg.vq.downsample_factor,
                             kv_quant="int8", decode_segments=8)
        ref = eng.forced_cfg_logits(prompts, forced)
        kernel = llama.decode_attention
        llama.decode_attention = da.decode_attention_plain
        # the plain version reads a host cur_len: the eager loop (a replay
        # of the graph captured above would not call it at all)
        eng._replays_trunk = lambda: False
        try:
            ctl = eng.forced_cfg_logits(prompts, forced)
        finally:
            llama.decode_attention = kernel
        del model, eng
        got = np.load(os.path.join(root, "forced.npy"))
        err = float(np.abs(got - ref).max())
        err_ctl = float(np.abs(ctl - ref).max())
        print(f"tp forced CFG logits (1B, int8, {len(prompts)} prompts, "
              f"{PROBE_TOKENS} tokens): tp = 2 vs one process max|d|={err:.3g};"
              f" the kernel's plain version vs the kernel max|d|={err_ctl:.3g};"
              f" max|ref|={float(np.abs(ref).max()):.3g}")
        self.check(np.isfinite(got).all() and got.shape == ref.shape
                   and err <= 2 * err_ctl,
                   f"tp forced CFG logits finite, within twice the control's "
                   f"distance from one process: {err:.3g} <= 2 x {err_ctl:.3g}")

        # (b) step 4b over phase 4's PNGs of TP_SCORE_ITEMS items, one process
        one = os.path.join(self.workdir, "tp_one_step4")
        os.makedirs(one)
        shutil.copy(os.path.join(spec["step4"]["save_path"], "vqa_prompt.json"),
                    one)
        scored, answers = step4.score_prepared_chunk, {}
        step4.score_prepared_chunk = lambda e, c: _keep_scores(scored, e, c,
                                                               answers)
        try:
            step4.main(Config.from_nested({**spec["step4"], "save_path": one}))
        finally:
            step4.score_prepared_chunk = scored
        theirs = ranks[0]["scores"]
        keys = sorted(answers)
        d_yes = max((abs(a[0] - b[0]) for k in keys
                     for a, b in zip(theirs.get(k, []), answers[k])),
                    default=float("nan"))
        agree = sum(np.sign(a[0] - a[1]) == np.sign(b[0] - b[1])
                    for k in keys for a, b in zip(theirs.get(k, []), answers[k]))
        total = sum(len(answers[k]) for k in keys)
        p_max = max(b[0] for k in keys for b in answers[k])
        print(f"tp step 4b (1B, int8, {len(keys)} images): {agree} of {total} "
              f"yes/no answers agree with one process; max|dp_yes|={d_yes:.3g} "
              f"(max p_yes {p_max:.3g}); tp scoring loop "
              f"{ranks[0]['step4_s']:.1f} s")
        self.check(len(keys) == 6 * TP_SCORE_ITEMS and sorted(theirs) == keys
                   and agree == total,
                   f"tp step 4b: {len(theirs)} images scored by the pair, "
                   f"{len(keys)} by one process; answers agree {agree}/{total}")

        # (c) the greedy text probe
        ids = tp_text_ids()
        same = np.asarray(ranks[0]["text_ids"]) == ids
        print(f"tp greedy text (1B, fp32 activations, int8 weights and KV, "
              f"{ids.shape[0]} prompts x "
              f"{TP_TEXT_TOKENS} tokens): {int(same.sum())} of {same.size} ids "
              f"equal one process's")
        self.check(bool(same.all()), "tp greedy text ids equal one process's")

    # -- phase 18 --------------------------------------------------------
    def tp_train_path(self):
        """18: step 5 at tp = 2 (1B LoRA from phase 15's directory) in two
        ranks on the one card, each a ``chip_smoke --tp-train-worker``
        process (:func:`tp_train_worker`), against ``step5.main`` in this
        process on the whole batch and, as the control, on two
        micro-batches of half the rows (module docstring, phase 18)."""
        import gc

        from ospo_tpu_torch.config import Config
        from ospo_tpu_torch.parallel import mesh as mesh_lib
        from ospo_tpu_torch.pipeline import step5
        from ospo_tpu_torch.train import checkpoint as ckpt_lib
        from ospo_tpu_torch.train import lora as lora_lib
        from ospo_tpu_torch.train.optim import leaves
        from ospo_tpu_torch.train.trainer import SimPOTrainer

        gc.collect()
        torch.cuda.empty_cache()
        root = os.path.join(self.workdir, "tp_step5")
        os.makedirs(root)
        records = train_records()[:TP_STEP5_BATCH]     # a batch an epoch
        self.check(len(records) == TP_STEP5_BATCH,
                   f"{len(records)} training records (want {TP_STEP5_BATCH})")
        data_path = os.path.join(root, "train.json")
        with open(data_path, "w") as f:
            json.dump(records, f)
        lcfg = lora_lib.LoraConfig(rank=32, alpha=64, dropout=0.0)
        tree = tp_step5_adapters(lcfg)
        init = ckpt_lib.save_checkpoint(os.path.join(root, "init"), 0, tree,
                                        lcfg)
        axes = dict(leaves(mesh_lib.lora_param_specs(tree)))
        del tree

        def config(name, batch, accum, tp):
            """configs/step5.yaml from the directory, resumed from the
            seeded adapters, no dropout, the flash path, every step
            logged, one save at the end."""
            model = {"model_path": self.synth["path"]}
            if tp > 1:
                model["tensor_parallel"] = tp
            return merged(STEP5_CONFIG, {
                "base": {"save_path": os.path.join(root, name),
                         "resume": init},
                "model": model,
                "dataset": {"train": {"data_path": data_path,
                                      "batch_size": batch}},
                "image_root": os.path.join(self.workdir, "step3"),
                "lora": {"lora_dropout": 0},
                "experiment": {"attn_impl": "flash",
                               "max_training_steps": TP_STEP5_STEPS,
                               "max_epochs": TP_STEP5_STEPS,
                               "save_steps": None, "log_steps": 1,
                               "gradient_accumulation_steps": accum}})

        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump({"config": config("tp", TP_STEP5_BATCH, 1, 2)}, f)
        run = self._launch("tp18", 2, "chip_smoke",
                           ["--tp-train-worker", root], timeout=600)
        self.check(sorted(run["runtime"].values()) == [
            "backend gloo device cuda:0"] * 2,
            f"both ranks on the one card take gloo: {run['runtime']}")
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"))
                 for r in range(2)]
        layers, micro = 24, TP_STEP5_STEPS
        want = {"flash_fwd": 2 * layers * micro, "flash_bwd_dq": layers * micro,
                "flash_bwd_dkv": layers * micro}
        for rank, st in sorted(run["summary"].items()):
            got = {k: st["launches"][k] for k in want}
            for k, n in got.items():
                self.launches[k] = self.launches.get(k, 0) + n
            self.check(st["global_step"] == TP_STEP5_STEPS and got == want
                       and ranks[rank]["heads"] == [8],
                       f"tp step 5 rank {rank}: {st['global_step']} steps, "
                       f"launches {got} == {want}, attention at "
                       f"H = {ranks[rank]['heads']} == [8]")

        # one process: the whole batch, and the control's two micro-batches
        # of half the rows (bf16 products of other shapes)
        runs = {}
        for name, batch, accum in (("one", TP_STEP5_BATCH, 1),
                                   ("half", TP_STEP5_BATCH // 2, 2)):
            with record_training(accum) as rec:
                trainer = step5.main(Config.from_nested(config(name, batch,
                                                               accum, 1)))
            runs[name] = {"trainer": trainer, **rec}
            del trainer
        half = runs.pop("half")
        del half["trainer"]
        gc.collect()
        one = runs["one"]

        def joined(key):
            """The ranks' ``key`` tree joined whole by the adapters' specs
            (opt state by its leaf's path)."""
            out = {}
            for k, t in ranks[0][key].items():
                axis = axes.get(k.partition("/")[2] if key == "opt" else k)
                out[k] = t if axis is None else torch.cat(
                    [ranks[0][key][k], ranks[1][key][k]], dim=axis)
            return out

        def worst(got, ref):
            """(path, max|got - ref| / max|ref|) of the worst leaf."""
            return max(((p, float((got[p].float() - ref[p].float()).abs().max()
                                  / ref[p].float().abs().max()))
                        for p in ref), key=lambda r: r[1])

        # (a) step 1's gradient, gathered, against one process's
        g_tp = joined("grads")
        g_half = {p: (half["grads"][0][p] + half["grads"][1][p]) / 2
                  for p in one["grads"][0]}
        err, ctl = worst(g_tp, one["grads"][0]), worst(g_half, one["grads"][0])
        print(f"tp step 5 step-1 gradient (B non-zero): tp = 2 vs one process "
              f"worst leaf {err[0]} {err[1]:.3g} max|ref|; control (two "
              f"micro-batches of half the rows vs the whole batch) worst "
              f"{ctl[0]} {ctl[1]:.3g} max|ref|")
        self.check(set(g_tp) == set(one["grads"][0]) and err[1] <= 2 * ctl[1],
                   f"tp step 5 gradients within twice the control: "
                   f"{err[1]:.3g} <= 2 x {ctl[1]:.3g}")
        del g_tp, g_half

        # (b) the 3 steps' losses
        l_tp, l_one = ranks[0]["losses"], one["losses"]
        l_half = [(a + b) / 2 for a, b in zip(half["losses"][::2],
                                               half["losses"][1::2])]
        d_tp = max(abs(a - b) for a, b in zip(l_tp, l_one))
        d_ctl = max(abs(a - b) for a, b in zip(l_half, l_one))
        print(f"tp step 5 losses {l_tp}, one process {l_one}, control "
              f"{l_half}: max|d| {d_tp:.3g} against the control's {d_ctl:.3g}")
        self.check(len(l_tp) == len(l_one) == TP_STEP5_STEPS
                   and ranks[1]["losses"] == l_tp and d_tp <= 2 * d_ctl,
                   f"tp step 5 losses equal on both ranks and within twice "
                   f"the control: {d_tp:.3g} <= 2 x {d_ctl:.3g}")

        # (c) the replicated leaves and their moments, bit-equal
        rep = [p for p, a in axes.items() if a is None]
        differ = [p for p in rep if not torch.equal(
            ranks[0]["trained"][p], ranks[1]["trained"][p])] + [
            k for k in (f"{m}/{p}" for m in ("mu", "nu") for p in rep)
            if not torch.equal(ranks[0]["opt"][k], ranks[1]["opt"][k])]
        self.check(len(rep) == 7 and not differ,
                   f"tp step 5: the {len(rep)} replicated adapter leaves and "
                   f"their moments bit-equal on both ranks after step "
                   f"{TP_STEP5_STEPS} (differ: {differ[:3]})")

        # (d) the checkpoint, resumed in one process
        path = os.path.join(root, "tp", "ospo", f"step_{TP_STEP5_STEPS:06d}")
        check = SimPOTrainer(Config.from_nested(config("check", TP_STEP5_BATCH,
                                                       1, 1)),
                             one["trainer"].model, one["trainer"].processor)
        check.resume(path)
        trained, opt = joined("trained"), joined("opt")
        bad = [p for p, t in leaves(check.trainable)
               if not torch.equal(t.detach().cpu(), trained[p])]
        state = check.opt.state_dict()
        bad += [k for k, t in opt.items() if k.partition("/")[0] in (
            "mu", "nu") and not torch.equal(state[k].cpu(), t)]
        self.check(check.global_step == TP_STEP5_STEPS and not bad,
                   f"tp step 5 checkpoint {path}: resumed in one process at "
                   f"step {check.global_step}, adapters and moments equal "
                   f"the ranks' shards joined (differ: {bad[:3]})")
        one_steps = one["trainer"].update_seconds
        del check, runs, one

        steps = [st["update_seconds"] for _, st in sorted(run["summary"].items())]
        later = sum(sum(s[1:]) for s in steps) / sum(len(s) - 1 for s in steps)
        coll = ranks[0]["collectives"]
        print(f"tp step 5, 1B LoRA r32 from the directory, tp = 2 on one card "
              f"(function, not scaling), global batch {TP_STEP5_BATCH}: "
              f"seconds a step {[[round(x, 3) for x in s] for s in steps]} "
              f"per rank; steps 2-{TP_STEP5_STEPS} {later:.3f} s, "
              f"{TP_STEP5_BATCH / later:.3f} pairs/s for the pair; one "
              f"process {[round(x, 3) for x in one_steps]}; card {_smi()}")
        for name, (calls, secs, nbytes) in coll.items():
            print(f"tp step 5 rank 0 collectives {name}: {calls} calls "
                  f"({calls / TP_STEP5_STEPS:.1f} a micro-batch), "
                  f"{nbytes / calls / 1e6:.1f} MB mean, {secs:.3f} s in all "
                  f"({secs / TP_STEP5_STEPS:.3f} s a micro-batch)")

    # -- phase 17 --------------------------------------------------------
    def start_weights_gate(self):
        """17's start: once 15a's writer has put the 1B directory down, the
        weights gate runs on it in a process of its own beside phases 13-16
        (``python -m ospo_tpu_torch.validate_weights``: port, modules,
        divergence with ``--weight-divergence``, samples; then the scoring
        reference exported in bf16 and compared in int8)."""
        rc = self.writer["proc"].wait(timeout=900)
        self.check(rc == 0, f"the 1B directory's writer exits 0 (rc {rc})")
        out = os.path.join(self.workdir, "gate")
        os.makedirs(out)
        gate = [sys.executable, "-m", "ospo_tpu_torch.validate_weights",
                "--model_path", self.writer["path"]]
        cmds = [gate + ["--out", os.path.join(out, "val"), "--phases",
                        "port,modules,divergence,samples", "--quantize", "none",
                        "--weight-divergence", "--tokens", "576", "--batch", "2"],
                gate + ["--out", os.path.join(out, "export"), "--phases",
                        "scoring", "--quantize", "none", "--export-reference",
                        os.path.join(out, "ref")],
                gate + ["--out", os.path.join(out, "compare"), "--phases",
                        "scoring", "--quantize", "int8", "--compare-reference",
                        os.path.join(out, "ref")]]
        log = os.path.join(out, "gate.log")
        with open(log, "w") as f:
            proc = subprocess.Popen(
                ["bash", "-c", " && ".join(shlex.join(c) for c in cmds)],
                cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True, env=dict(
                    os.environ, PYTHONPATH=os.pathsep.join(
                        [ROOT, os.environ.get("PYTHONPATH", "")])))
        self.gate = {"proc": proc, "out": out, "log": log, "t0": time.time()}
        print(f"weights gate: started (pid {proc.pid}) on {self.writer['path']}")

    def weights_gate(self):
        """17: the gate's reports — finite, with the JAX script's keys — and
        its KL and top-1 agreement for each KV and weight mode."""
        import re

        import numpy as np

        from ospo_tpu_torch.io import read_json
        from ospo_tpu_torch.utils.png import read_png

        g = self.gate
        t0 = time.time()
        rc = g["proc"].wait(timeout=600)
        log = open(g["log"]).read()
        print(f"weights gate: rc {rc}, {time.time() - g['t0']:.1f} s since its "
              f"start, waited {time.time() - t0:.1f} s")
        if rc != 0:
            print(f"--- weights gate output (last 6000 bytes) ---\n{log[-6000:]}")
        self.check(rc == 0, "the weights gate's three runs exit 0")
        rep = read_json(os.path.join(g["out"], "val", "validation_report.json"))
        div = rep["divergence"]
        modes = ["kv_int8_vs_bf16", "kv_int4_vs_bf16", "w_int8_vs_bf16",
                 "w_w8a8_vs_bf16", "w_int4_vs_bf16", "w_int4g_vs_bf16"]
        metric_keys = {"kl_mean", "kl_max", "top1_agree", "by_quarter"}

        def finite(m):
            vals = [m["kl_mean"], m["kl_max"], m["top1_agree"]] + [
                q[k] for q in m["by_quarter"] for k in q]
            return bool(np.isfinite(vals).all())

        for key in modes:
            m = div[key]
            print(f"weights gate (1B, random weights, bf16 reference, 2 "
                  f"prompts x {div['n_tokens']} tokens) {key}: KL mean "
                  f"{m['kl_mean']:.5g}, max {m['kl_max']:.5g}, top-1 "
                  f"{m['top1_agree']:.4f}; by quarter KL "
                  f"{[round(q['kl_mean'], 5) for q in m['by_quarter']]}, top-1 "
                  f"{[round(q['top1_agree'], 4) for q in m['by_quarter']]}")
        ok = (set(rep) == {"model_path", "phases", "quantize", "port",
                           "modules", "divergence", "samples", "elapsed_s"}
              and set(div) == set(modes) | {"n_tokens", "batch"}
              and div["n_tokens"] == 576 and div["batch"] == 2
              and all(set(div[k]) == metric_keys and len(div[k]["by_quarter"])
                      == 4 and finite(div[k]) for k in modes))
        self.check(ok, "validation_report.json: the JAX script's keys, six "
                       "finite divergence entries of 576 tokens by quarter")
        samples = rep["samples"]["samples"]
        real = [_real_png(read_png(s["path"])) for s in samples]
        self.check(rep["port"]["ok"] and rep["modules"]["ok"]
                   and set(rep["modules"]) == {"vit_embeds", "vq_roundtrip",
                                               "trunk", "ok"}
                   and rep["samples"]["ok"] and len(samples) == 3 and all(real),
                   f"weights gate: port ok ({len(rep['port']['modules'])} "
                   f"modules), modules ok, 3 real sample PNGs {real}; "
                   f"{rep['elapsed_s']} s")
        # each run's kernel launches, from its summary line
        decoder = json.JSONDecoder()
        runs = [decoder.raw_decode(log, m.end())[0]["launches"] for m in
                re.finditer(r"# validate_weights process 0/1: ", log)]
        total = {k: sum(r[k] for r in runs) for k in runs[0]} if runs else {}
        for name, n in total.items():
            self.launches[name] = self.launches.get(name, 0) + n
        print(f"weights gate: launches of its {len(runs)} runs {runs}")
        self.check(len(runs) == 3 and total["flash_fwd"] > 0
                   and total["decode_attention"] > 0
                   and total["int4_matmul_row"] > 0
                   and total["int4_matmul_group"] > 0,
                   f"the gate's runs launched the flash, decode and int4 "
                   f"kernels: {total}")
        sc = read_json(os.path.join(g["out"], "compare",
                                    "validation_report.json"))["scoring"]
        m = sc["scoring_int8_vs_bf16"]
        print(f"weights gate scoring (1B, {sc['n_readouts']} readouts of "
              f"{sc['n_items']} items), int8 shared prefix vs bf16 unshared: "
              f"mean|dp_yes| {m['mean_abs_dp_yes']:.4g}, max "
              f"{m['max_abs_dp_yes']:.4g}, answers {m['answer_agree']:.4f}, "
              f"pairs {m['pair_agree']:.4f}; card {_smi()}")
        self.check(set(m) == {"mean_abs_dp_yes", "max_abs_dp_yes",
                              "answer_agree", "pair_agree"}
                   and bool(np.isfinite(list(m.values())).all()),
                   "the scoring comparison's four finite keys")
        shutil.rmtree(self.synth["path"], ignore_errors=True)


class _Timed:
    """Times the named module functions while active (host clock around a
    synchronised call; seconds summed over calls)."""

    def __init__(self, targets):
        self.targets = targets
        self.seconds = {name: 0.0 for _, name in targets}
        self.saved = []

    def __enter__(self):
        for module, name in self.targets:
            real = getattr(module, name)

            def timed(*a, _real=real, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.time()
                try:
                    return _real(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    self.seconds[_name] += time.time() - t0

            self.saved.append((module, name, real))
            setattr(module, name, timed)
        return self

    def __exit__(self, *exc):
        for module, name, real in self.saved:
            setattr(module, name, real)


class _ScoreRecorder:
    """Watches step 4b while active: the scoring loop's seconds
    (``step4.run_scoring``), the engine's counts, and per shared-program
    slice its buckets and CUDA-event times of the ViT, the pre-image
    prefill, the image prefill and the suffixes."""

    PARTS = {"_encode_images": "vit", "_prefill_pre": "pre",
             "_prefill_images": "prefill", "_suffix_probs": "suffix"}

    def __init__(self, step4):
        self.step4 = step4

    def __enter__(self):
        from ospo_tpu_torch.engine.scoring import ScoringEngine

        self.cls, self.saved = ScoringEngine, {}
        self.slices, self.loop, self.engines = [], [], []
        rec = self

        def timed(name, orig):
            def call(eng, *args, **kw):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = orig(eng, *args, **kw)
                ev[1].record()
                if rec.slices:
                    rec.slices[-1]["events"].setdefault(name, []).append(ev)
                return out
            return call

        def slice_call(eng, operands, pre, q_counts):
            t = time.perf_counter()
            rec.slices.append({"rows": operands[0].shape[0], "events": {},
                               "q_b": operands[5].shape[0],
                               "bucket": (operands[0].shape[1],
                                          operands[5].shape[2],
                                          None if pre is None else pre[0].shape[1])})
            out = rec.saved["_execute_shared_slice"](eng, operands, pre, q_counts)
            rec.slices[-1]["host_s"] = time.perf_counter() - t
            return out

        for name, part in self.PARTS.items():
            self.saved[name] = getattr(ScoringEngine, name)
            setattr(ScoringEngine, name, timed(part, self.saved[name]))
        self.saved["_execute_shared_slice"] = ScoringEngine._execute_shared_slice
        ScoringEngine._execute_shared_slice = slice_call
        self.run_scoring = self.step4.run_scoring

        def run_scoring(config, engine, data):
            rec.engines.append(engine)
            t = time.perf_counter()
            out = rec.run_scoring(config, engine, data)
            torch.cuda.synchronize()
            rec.loop.append(time.perf_counter() - t)
            return out

        self.step4.run_scoring = run_scoring
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)
        self.step4.run_scoring = self.run_scoring

    def summary(self) -> dict:
        n = max(1, len(self.slices))

        def per_slice(part):
            return sum(a.elapsed_time(b) for s in self.slices
                       for a, b in s["events"].get(part, [])) / n

        out = {p: per_slice(p) for p in ("vit", "pre", "prefill", "suffix")}
        return {
            "slices": len(self.slices),
            "suffix_passes": sum(s["q_b"] for s in self.slices),
            "rows": sorted({s["rows"] for s in self.slices}),
            "buckets": sorted({s["bucket"] for s in self.slices}, key=str),
            "vit_ms": out["vit"], "pre_ms": out["pre"],
            "prefill_ms": out["prefill"], "suffix_ms": out["suffix"],
            "device_ms": sum(out.values()),
            "slice_ms": 1e3 * sum(s["host_s"] for s in self.slices) / n,
            "loop_s": sum(self.loop),
            "counts": self.engines[0].counts if self.engines else None,
        }


class _TextRecorder:
    """Watches every ``TextGenEngine.generate_ids`` call while active: the
    batch, the prefix and tail buckets, the steps run, the call's seconds
    (it returns host arrays, so it has synchronised), and a CUDA event and
    a host time at each decode step (the engine's ``step_hook``)."""

    def __enter__(self):
        from ospo_tpu_torch.engine.text_engine import TextGenEngine

        self.cls, self.orig, self.calls = TextGenEngine, TextGenEngine.generate_ids, []
        orig, calls = self.orig, self.calls

        def generate_ids(eng, prompts, seed=None, generator=None):
            split = eng._shared_split(prompts)
            events, host = [], []

            def hook(step):
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
                host.append(time.perf_counter())

            eng.step_hook = hook
            t0 = time.perf_counter()
            out = orig(eng, prompts, seed=seed, generator=generator)
            seconds = time.perf_counter() - t0
            eng.step_hook = None
            n = len(events)
            mid = range(max(1, n // 2 - 8), min(n - 1, n // 2 + 8))
            calls.append({
                "rows": len(prompts), "bucket": eng._batch_bucket(len(prompts)),
                "prefix": None if split is None else split[0].shape[1],
                "tail": None if split is None else split[2].shape[1],
                "steps": n, "seconds": seconds,
                "step_ms": [events[i].elapsed_time(events[i + 1]) for i in mid],
                "host_ms": [(host[i + 1] - host[i]) * 1e3 for i in mid]})
            return out

        TextGenEngine.generate_ids = generate_ids
        return self

    def __exit__(self, *exc):
        self.cls.generate_ids = self.orig

    def summary(self) -> dict:
        calls = self.calls
        mean = lambda xs: sum(xs) / max(1, len(xs))  # noqa: E731
        tokens = sum(c["rows"] * c["steps"] for c in calls)
        seconds = sum(c["seconds"] for c in calls)
        return {
            "calls": len(calls),
            "batch": sorted({c["rows"] for c in calls}),
            "bucket": sorted({c["bucket"] for c in calls}),
            "prefix": sorted({c["prefix"] for c in calls}, key=str),
            "tail": sorted({c["tail"] for c in calls}, key=str),
            "tokens": tokens, "seconds": seconds,
            "tok_per_s": tokens / seconds if seconds else 0.0,
            "mid_step_ms": mean([x for c in calls for x in c["step_ms"]]),
            "mid_host_ms": mean([x for c in calls for x in c["host_ms"]]),
            "plain_steps": sum(c["steps"] - 1 for c in calls
                               if c["prefix"] is None),
        }


def step2_prefix():
    """(common tokens, prefix bucket) of phase 8's step-2 batch, 2a's first
    perturbation: the B = 1 prefill the flash forward runs there."""
    import types

    from ospo_tpu_torch.engine.text_engine import TextGenEngine
    from ospo_tpu_torch.io import read_json
    from ospo_tpu_torch.pipeline.step2 import build_negative_prompts
    from ospo_tpu_torch.processing import Processor
    from ospo_tpu_torch.tokenizer import load_tokenizer

    group = [r for r in read_json(BASE_FIXTURE) if r["sub_category"] == "complex"]
    for r in group:
        r["perturbed_method"] = ["replace", "swap", "drop"]
    prompts = [p for p in build_negative_prompts(group, 0, 0)[0] if p]
    eng = TextGenEngine(types.SimpleNamespace(device=None),
                        Processor(load_tokenizer(None, vocab_size=102400)))
    prefix_mask = eng._shared_split(prompts)[1]
    return int(prefix_mask.sum()), prefix_mask.shape[1]


def step1_prompt_bucket():
    """(tokens, bucket) of phase 8's step-1 prompt (category object) on the
    plain program."""
    from ospo_tpu_torch import chat
    from ospo_tpu_torch.engine.text_engine import _bucket_tail
    from ospo_tpu_torch.pipeline.templates import get_element_conversation
    from ospo_tpu_torch.tokenizer import load_tokenizer

    system, conv = get_element_conversation("object")
    prompt = chat.apply_sft_template(conv, system_prompt=system)
    n = len(load_tokenizer(None, vocab_size=102400).encode(prompt))
    return n, _bucket_tail(n)


def score_items():
    """The step-4 fixture's question records of the items phase 4 draws."""
    from ospo_tpu_torch.io import read_json

    items = {(d["category"], d["item_id"]) for d in read_json(FIXTURE)[:N_ITEMS]}
    return [r for r in read_json(VQA_FIXTURE)
            if (r["category"], r["item_id"]) in items]


def score_buckets(pre_image_prefix: bool) -> list:
    """Per step-4b chunk of phase 9 (16 images, Q-sorted, byte tokenizer,
    384 px): the prefix bucket ``p_b`` and its token count ``rest``, the
    suffix bucket ``t_b``, and the pre-image bucket ``pre_c`` with its
    token count ``pre_n`` (None without the split)."""
    import types

    import numpy as np

    from ospo_tpu_torch.engine.scoring import ScoringEngine
    from ospo_tpu_torch.image_processing import ImageProcessor
    from ospo_tpu_torch.processing import Processor
    from ospo_tpu_torch.tokenizer import load_tokenizer

    proc = Processor(load_tokenizer(None, vocab_size=102400),
                     ImageProcessor(image_size=384), num_image_tokens=576)
    eng = ScoringEngine(types.SimpleNamespace(device=None), proc,
                        pre_image_prefix=pre_image_prefix)
    qs = sorted((r["question"] for r in score_items() for _ in range(6)), key=len)
    rows = STEP4_CONFIG["score_rows"]
    img = np.zeros((384, 384, 3), np.uint8)
    out = []
    for c0 in range(0, len(qs), rows):
        chunk = qs[c0:c0 + rows]
        prep = eng.prepare_shared_multi([img] * len(chunk), chunk)
        out.append({"p_b": prep.operands[0].shape[1],
                    "rest": int(prep.operands[1][0].sum()),
                    "t_b": prep.operands[5].shape[2],
                    "pre_c": None if prep.pre is None else prep.pre[0].shape[1],
                    "pre_n": None if prep.pre is None else int(prep.pre[1].sum())})
    return out


def inference_prompts():
    """Phase 10's prompt list: the first 24 long prompts of the step-2
    fixture, in order."""
    from ospo_tpu_torch.io import read_json

    return [p for item in read_json(FIXTURE) for p in item["long_prompt"]][:24]


def train_records():
    """The records of the step-4 fixture whose images phase 4 writes."""
    from ospo_tpu_torch.io import read_json

    items = {(d["category"], d["item_id"]) for d in read_json(FIXTURE)[:N_ITEMS]}
    return [r for r in read_json(TRAIN_FIXTURE)
            if (r["category"], r["item_id"]) in items]


def train_bucket(n_records=None) -> int:
    """Phase 5's run-level text bucket, as the trainer computes it (phase
    18's over its first ``n_records``)."""
    from ospo_tpu_torch.processing import Processor, t2i_prompt
    from ospo_tpu_torch.tokenizer import load_tokenizer
    from ospo_tpu_torch.train.trainer import _bucket

    proc = Processor(load_tokenizer(None, vocab_size=102400))
    return _bucket(max(len(proc.tokenizer.encode(t2i_prompt(proc, r["prompt"])))
                       for r in train_records()[:n_records]))


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


def tp_spec(root: str, model_path: str, image_root: str) -> dict:
    """Phase 16's inputs, written to ``<root>/spec.json`` for its ranks:
    step 3's configuration and items (the first prompt-kind of the first
    ``TP_STEP3_ITEMS // 3`` fixture items, one prompt an item) and step
    4b's configuration over ``image_root``."""
    from ospo_tpu_torch.io import read_json

    data = [{**sample, "item_id": f"{sample['item_id']}{j}",
             "long_prompt": [prompt, "", ""],
             "negative_long_prompt": ["", "", ""]}
            for sample in read_json(FIXTURE)[:TP_STEP3_ITEMS // 3]
            for j, prompt in enumerate(sample["long_prompt"])]
    data_path = os.path.join(root, "long_prompt.json")
    with open(data_path, "w") as f:
        json.dump(data, f)
    spec = {"model_path": model_path,
            "step3": {**STEP3_CONFIG, "model_path": model_path,
                      "data_path": data_path, "e_idx": TP_STEP3_ITEMS,
                      "save_path": os.path.join(root, "step3")},
            "step4": {**STEP4_CONFIG, "model_path": model_path,
                      "image_path": image_root,
                      "save_path": os.path.join(root, "step4")}}
    with open(os.path.join(root, "spec.json"), "w") as f:
        json.dump(spec, f)
    return spec


def tp_probe_inputs(proc, vocab: int):
    """Phase 16's forced CFG probe: ``PROBE_PROMPTS`` fixture prompts and
    ``PROBE_TOKENS`` seeded image tokens."""
    from ospo_tpu_torch.io import read_json
    from ospo_tpu_torch.processing import t2i_prompt

    prompts = [t2i_prompt(proc, s["long_prompt"][0])
               for s in read_json(FIXTURE)[:PROBE_PROMPTS]]
    forced = torch.randint(0, vocab, (len(prompts), PROBE_TOKENS),
                           generator=torch.Generator().manual_seed(0)).numpy()
    return prompts, forced


def tp_text_ids(tensor_parallel: int = 1):
    """Phase 16's greedy text probe: ``TP_TEXT_TOKENS`` ids of the first
    ``TP_TEXT_PROMPTS`` step-1 fixture prompts from a Janus-Pro-1B trunk
    with fp32 activations (random int8 weights, seed ``SYNTH_SEED``, the
    text steps' int8 cache), sharded at ``tensor_parallel`` > 1.  The
    argmax of random weights' bf16 logits ties too often for two
    computations to agree, so the probe runs in fp32 (phase 13's fp32
    probe, for the same reason)."""
    import dataclasses

    from ospo_tpu_torch.engine.text_engine import TextGenEngine
    from ospo_tpu_torch.io import read_json
    from ospo_tpu_torch.models import janus
    from ospo_tpu_torch.parallel import mesh as mesh_lib
    from ospo_tpu_torch.platform import resolve_device
    from ospo_tpu_torch.processing import Processor
    from ospo_tpu_torch.tokenizer import load_tokenizer

    cfg = janus.JANUS_PRO_1B
    f32 = dataclasses.replace(cfg, dtype=torch.float32, language=dataclasses.replace(
        cfg.language, dtype=torch.float32))
    model = janus.JanusModel.init(f32, seed=SYNTH_SEED, quantize="int8",
                                  device=resolve_device(None), vision=False)
    if tensor_parallel > 1:
        model.params = mesh_lib.shard_janus_params(
            model.params, mesh_lib.create_mesh(tensor_parallel))
    proc = Processor(load_tokenizer(None, vocab_size=cfg.language.vocab_size))
    prompts = [r["prompt"] for r in read_json(BASE_FIXTURE)[:TP_TEXT_PROMPTS]]
    return TextGenEngine(model, proc, max_new_tokens=TP_TEXT_TOKENS,
                         do_sample=False, kv_quant="int8").generate_ids(prompts)


def _keep_scores(scored, engine, chunk, answers: dict):
    """``step4.score_prepared_chunk`` that also keeps each image's (p_yes,
    p_no) per question in ``answers`` by path."""
    out = scored(engine, chunk)
    for job, res in zip(chunk["jobs"], out):
        if res is not None:
            answers[job["path"]] = [[a["p_yes"], a["p_no"]]
                                    for a in res["answer_metadata"]]
    return out


def tp_worker(workdir: str) -> int:
    """One rank of phase 16 (``python3 -m chip_smoke --tp-worker DIR``,
    started by ``scripts/run_multihost_torch.sh 2``): step 3 at tp = 2 with
    the KV cache's head count recorded, the forced CFG probe, step 4b with
    each image's readouts, the greedy text probe.  Rank 0 saves the probe's
    logits as ``forced.npy``; each rank writes ``rank<r>.json``."""
    import gc

    import numpy as np

    from ospo_tpu_torch.config import Config
    from ospo_tpu_torch.engine.image_engine import ImageGenEngine
    from ospo_tpu_torch.io import process_index, read_json
    from ospo_tpu_torch.models import llama
    from ospo_tpu_torch.pipeline import step3, step4
    from ospo_tpu_torch.pipeline.model_factory import get_model
    from ospo_tpu_torch.platform import maybe_init_distributed

    maybe_init_distributed()
    rank = process_index()
    spec = read_json(os.path.join(workdir, "spec.json"))
    res = {}
    heads, init = [], llama.init_kv_cache

    def init_kv_cache(cfg, *a, **k):
        heads.append(cfg.num_heads)
        return init(cfg, *a, **k)

    llama.init_kv_cache = init_kv_cache
    n0 = kernel_launches()
    try:
        stats = step3.main(Config.from_nested({**spec["step3"],
                                               "tensor_parallel": 2}))
    finally:
        llama.init_kv_cache = init
    res["step3"] = {**stats, "launches": launched(n0, "flash_fwd",
                                                  "decode_attention")}
    res["cache_heads"] = sorted(set(heads))
    gc.collect()

    model, _, proc = get_model(Config.from_nested({**spec["step3"],
                                                   "tensor_parallel": 2}))
    prompts, forced = tp_probe_inputs(proc, model.cfg.image_token_size)
    logits = ImageGenEngine(
        model, proc, image_token_num=PROBE_TOKENS,
        img_size=model.cfg.gen_image_size,
        patch_size=model.cfg.vq.downsample_factor, kv_quant="int8",
        decode_segments=8).forced_cfg_logits(prompts, forced)
    if rank == 0:
        np.save(os.path.join(workdir, "forced.npy"), logits)
    del model
    gc.collect()

    scored, answers = step4.score_prepared_chunk, {}
    step4.score_prepared_chunk = lambda e, c: _keep_scores(scored, e, c,
                                                           answers)
    t0 = time.time()
    try:
        step4.main(Config.from_nested({**spec["step4"], "tensor_parallel": 2}))
    finally:
        step4.score_prepared_chunk = scored
    res["step4_s"] = time.time() - t0
    res["scores"] = answers
    gc.collect()

    res["text_ids"] = tp_text_ids(2).tolist()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def tp_step5_adapters(lcfg):
    """Phase 18's starting adapters: the whole 1B tree of ``init_lora``
    (seed ``TP_STEP5_SEED``, on the host) with B drawn N(0, 0.01²), so that
    every A has a gradient at step 1 (a zero B hides a missing sum of A's
    partial gradients)."""
    from ospo_tpu_torch.models import janus
    from ospo_tpu_torch.train import lora as lora_lib

    tree = lora_lib.init_lora(janus.JANUS_PRO_1B.language, lcfg, TP_STEP5_SEED)
    gen = torch.Generator().manual_seed(TP_STEP5_SEED)
    for ab in tree.values():
        ab["b"].normal_(0.0, 0.01, generator=gen)
    return tree


@contextlib.contextmanager
def record_training(n_grads: int):
    """While active, every ``SimPOTrainer`` records each micro-batch's loss
    (``losses``) and its first ``n_grads`` reduced gradients (``grads``:
    ``{path: fp32 host tensor}``, this rank's leaves)."""
    from ospo_tpu_torch.train.optim import leaves
    from ospo_tpu_torch.train.trainer import SimPOTrainer

    rec = {"losses": [], "grads": []}
    step, reduce = SimPOTrainer._step, SimPOTrainer._reduce_grads

    def _step(self, *args, **kw):
        metrics = step(self, *args, **kw)
        rec["losses"].append(float(metrics["loss"]))
        return metrics

    def _reduce_grads(self, grads):
        out = reduce(self, grads)
        if len(rec["grads"]) < n_grads:
            rec["grads"].append({p: g.detach().float().cpu()
                                 for p, g in leaves(out)})
        return out

    SimPOTrainer._step, SimPOTrainer._reduce_grads = _step, _reduce_grads
    try:
        yield rec
    finally:
        SimPOTrainer._step, SimPOTrainer._reduce_grads = step, reduce


def tp_train_worker(workdir: str) -> int:
    """One rank of phase 18 (``python3 -m chip_smoke --tp-train-worker
    DIR``, started by ``scripts/run_multihost_torch.sh 2``): ``step5.main``
    at tp = 2 on ``<DIR>/spec.json``'s configuration, recording each
    micro-batch's loss, step 1's reduced gradient, the attention's head
    counts and the model group's collectives (count, host seconds with the
    card synchronised, bytes); each rank saves its own leaves, moments and
    records as ``rank<r>.pt``."""
    from ospo_tpu_torch.config import Config
    from ospo_tpu_torch.io import process_index, read_json
    from ospo_tpu_torch.models import llama
    from ospo_tpu_torch.parallel import mesh as mesh_lib
    from ospo_tpu_torch.pipeline import step5
    from ospo_tpu_torch.platform import maybe_init_distributed
    from ospo_tpu_torch.train.optim import leaves

    spec = read_json(os.path.join(workdir, "spec.json"))
    maybe_init_distributed(spec["config"].get("device"))
    rank = process_index()
    heads, attention = set(), llama.attention
    coll = {}
    real = {name: getattr(mesh_lib, name)
            for name in ("_sum_model", "_gather_last")}

    def counted_attention(q, *args, **kw):
        heads.add(q.shape[2])
        return attention(q, *args, **kw)

    def timed(name, fn):
        def call(x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x)
            torch.cuda.synchronize()
            calls, secs, nbytes = coll.get(name, (0, 0.0, 0))
            coll[name] = (calls + 1, secs + time.perf_counter() - t0,
                          nbytes + out.numel() * out.element_size())
            return out
        return call

    llama.attention = counted_attention
    for name, fn in real.items():
        setattr(mesh_lib, name, timed(name, fn))
    try:
        with record_training(1) as rec:
            trainer = step5.main(Config.from_nested(spec["config"]))
    finally:
        llama.attention = attention
        for name, fn in real.items():
            setattr(mesh_lib, name, fn)
    torch.save({"grads": rec["grads"][0], "losses": rec["losses"],
                "heads": sorted(heads), "collectives": coll,
                "trained": {p: t.detach().cpu()
                            for p, t in leaves(trainer.trainable)},
                "opt": {k: v.cpu() for k, v in trainer.opt.state_dict().items()}},
               os.path.join(workdir, f"rank{rank}.pt"))
    return 0


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _real_png(img) -> bool:
    """A 384x384 RGB uint8 image that is not one colour."""
    return (img.shape == (384, 384, 3) and img.dtype.name == "uint8"
            and int(img.max()) != int(img.min()))


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
    parser.add_argument("--moe-only", action="store_true",
                        help="phase 1, phase 2's MoE, GDN and KDA kernels, phases "
                             "19 to 21 only")
    parser.add_argument("--tp-worker", metavar="DIR",
                        help="run one rank of phase 16 on the inputs in DIR "
                             "(started by the script itself)")
    parser.add_argument("--tp-train-worker", metavar="DIR",
                        help="run one rank of phase 18 on the inputs in DIR "
                             "(started by the script itself)")
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
    if args.tp_worker:
        return tp_worker(args.tp_worker)
    if args.tp_train_worker:
        return tp_train_worker(args.tp_train_worker)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    smoke = None
    try:
        smoke = Smoke(workdir)
        smoke.phase("environment and kernel build", smoke.environment)
        if smoke.failures:
            return 1
        if args.moe_only:
            smoke.phase("moe kernels vs plain", smoke.moe_kernels)
            smoke.phase("gdn_decode kernel vs plain", smoke.gdn_kernel)
            smoke.phase("kda_decode kernel vs plain", smoke.kda_kernel)
            smoke.phase("main path: step 3 on an MLA/MoE trunk at DeepSeek-V2-Lite "
                        "width", smoke.moe_path)
            smoke.phase("main path: a step of the Qwen3-Next trunk", smoke.hybrid_step)
            smoke.phase("main path: the Kimi Linear trunk through the engine's graph",
                        smoke.kimi_step)
        else:
            smoke.phase("flash_fwd kernel vs plain", smoke.flash_kernel)
            smoke.phase("flash dQ and dK/dV kernels vs plain",
                        smoke.flash_backward_kernels)
            smoke.phase("decode_attention kernel vs plain", smoke.decode_kernel)
            smoke.phase("int4 row and group decode-matmul kernels vs plain",
                        smoke.int4_kernels)
            smoke.phase("moe kernels vs plain", smoke.moe_kernels)
            smoke.phase("gdn_decode kernel vs plain", smoke.gdn_kernel)
            smoke.phase("kda_decode kernel vs plain", smoke.kda_kernel)
            smoke.phase("w8a16_matmul kernel vs plain", smoke.w8a16_kernel)
            smoke.phase("suffix_attention kernel vs plain", smoke.suffix_kernel)
            smoke.phase("layer tail kernels vs plain", smoke.layer_tail_kernels)
            smoke.phase("flash_fwd and decode_attention at the text shapes",
                        smoke.text_kernels)
            smoke.phase("flash_fwd at the step-4b scoring shapes",
                        smoke.scoring_kernels)
            smoke.phase("small model GPU vs CPU", smoke.small_model)
            smoke.phase("small model text decode GPU vs CPU", smoke.small_text)
            smoke.phase("small model scoring GPU vs CPU", smoke.small_scoring)
            smoke.phase("small model training step GPU vs CPU",
                        smoke.small_train_step)
            smoke.phase("small model bf16 training step, backward kernels vs "
                        "plain", smoke.small_train_step_bf16)
        if not (args.skip_main or args.moe_only):
            smoke.phase("main path: step 3 at 7B width", smoke.main_path)
            smoke.phase("main path: step 5 at 7B width", smoke.train_path)
            smoke.phase("main path: step 3 at 7B width, quantize int4g",
                        lambda: smoke.int4_path("int4g"))
            smoke.phase("main path: step 3 at 7B width, quantize int4",
                        lambda: smoke.int4_path("int4"))
            smoke.phase("main path: steps 1, 2 and 4a at 7B width",
                        smoke.text_path)
            smoke.phase("main path: step 4b at 7B width", smoke.score_path)
            smoke.phase("main path: inference CLI at 7B width from phase 5's "
                        "LoRA checkpoint", smoke.inference_path)
            smoke.phase("synthetic 1B directory, start its writer",
                        smoke.start_synthetic_write)
            smoke.phase("main path: step 5 full fine-tune at 1B width",
                        smoke.full_finetune_path)
            smoke.phase("main path: step 5 at 7B width on an int8 trunk",
                        lambda: smoke.trunk_path("int8"))
            smoke.phase("weights gate at 1B width, start it beside phases "
                        "13-16", smoke.start_weights_gate)
            smoke.phase("main path: step 3 at 7B width, decode modes (bshd "
                        "plain read, SJD, int4 KV)", smoke.decode_modes_path)
            smoke.phase("main path: step 4b at 7B width, quantize w8a8",
                        smoke.w8a8_score_path)
            smoke.phase("main path: step 5 at 7B width on a w8a8 trunk",
                        lambda: smoke.trunk_path("w8a8"))
            smoke.phase("main path: synthetic 1B directory, write",
                        smoke.synthetic_write)
            smoke.phase("main path: synthetic 1B directory, load on the card",
                        smoke.synthetic_load)
            smoke.phase("main path: step 3 at 1B width from the directory, "
                        "two ranks on one card", smoke.synthetic_step3)
            smoke.phase("main path: step 5 at 1B width from the directory, "
                        "two ranks against one", smoke.synthetic_step5)
            smoke.phase("main path: tensor parallel at 1B width from the "
                        "directory, tp = 2 in two ranks on one card",
                        smoke.tp_path)
            smoke.phase("main path: step 5 under tensor parallel at 1B width "
                        "from the directory, tp = 2 in two ranks on one card",
                        smoke.tp_train_path)
            smoke.phase("main path: the weights gate at 1B width from the "
                        "directory", smoke.weights_gate)
            smoke.phase("main path: step 3 on an MLA/MoE trunk at DeepSeek-V2-Lite "
                        "width", smoke.moe_path)
            smoke.phase("main path: a step of the Qwen3-Next trunk", smoke.hybrid_step)
            smoke.phase("main path: the Kimi Linear trunk through the engine's graph",
                        smoke.kimi_step)
    finally:
        if smoke is not None:
            smoke.close()
        shutil.rmtree(workdir, ignore_errors=True)
    if smoke.failures or args.skip_main:
        print(f"FAILED: {smoke.failures}")
        return 1
    if args.moe_only:
        print(json.dumps({"ok": True, "moe_only": True}))
        return 0
    for name, entry in smoke.kernels.items():
        entry["launches"] = smoke.launches.get(name, 0)
    print(json.dumps({"kernels": list(smoke.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
