"""CFG image-token decode engine (step 3) — counterpart of
``ospo_tpu/engine/image_engine.py``.

- cond/uncond pairs are one fused batch of 2B rows ([0:B] cond, [B:2B]
  uncond);
- the prompt prefill runs once through the flash kernel into a preallocated
  KV cache, then 576 image tokens are decoded one step at a time;
- the CFG combine ``uncond + w·(cond − uncond)``, temperature and sampling
  run in fp32; the sampled token is fed back through gen_embed → gen_aligner;
- ``decode_code`` turns the tokens into uint8 pixels on the device.

The default cache is the batch-minor ``shbd`` one with a model-dtype or int8
payload: each step reads it with the decode-attention kernel, which reads
only the populated rows, so the window is always the whole (64-aligned)
cache — the JAX engine with ``decode_kernel: true``.  The ``bshd`` and
``bhsd`` layouts and the int4 cache read through the plain
``xla_attention``, the JAX engine's XLA path: there ``decode_segments``
growing windows bound each read.  ``speculative: W`` runs speculative
Jacobi decoding (``_generate_tokens_sjd``) on a ``bshd`` / ``bhsd`` cache.

On the card the kernel's cached trunk step is captured once as a CUDA
graph (``_TrunkGraph``) and replayed for every step: the step's ~10
kernels a layer are launched by one call instead of one Python call each,
so the host no longer sets the decode's pace.  Where a graph cannot hold,
the loop stays eager: the CPU, the plain reads (``bshd``/``bhsd``, int4
cache), SJD, and a model group of several ranks (whose collectives are
not captured).

Under tensor parallel (``parallel/mesh.py``) every rank of a model group
runs the same loop on its heads; the sampled ids (and SJD's accepted state)
are model rank 0's, broadcast to the group, so all ranks feed the same
tokens and take the same host branches.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ospo_tpu_torch.constants import (IMAGE_TOKEN_NUM_PER_IMAGE, IMG_SIZE,
                                      PATCH_SIZE)
from ospo_tpu_torch.models import janus as janus_lib
from ospo_tpu_torch.models import deepseek_v2, llama, qwen3_next, vqgan
from ospo_tpu_torch.ops.quant import parse_kv_quant
from ospo_tpu_torch.ops.sampling import sample_categorical
from ospo_tpu_torch.parallel import mesh as mesh_lib
from ospo_tpu_torch.processing import Processor, t2i_prompt
from ospo_tpu_torch.utils.profiling import (add_kernel_launches,
                                            kernel_launches, span)


def _bucket(n: int, step: int = 64) -> int:
    return max(step, ((n + step - 1) // step) * step)


class _TrunkGraph:
    """One cached trunk step of :meth:`ImageGenEngine._segmented_decode`
    (``language_forward`` at T = 1 over the decode kernel's ``shbd`` cache,
    its length in device memory) captured as a CUDA graph, and the static
    buffers the step reads and writes: the cache, the window mask, the
    step's embeds and positions, and the length, which the step advances.
    The kernel reads only ``[0, length)`` and the positions are device
    values, so one graph serves every call of its rows whose window fits
    ``s_max``.

    The first step after the buffers are made runs eagerly on the capture
    stream, so that lazy set-up (libraries, cuBLAS handles, kernel plans)
    stays out of the capture; the step is captured after it and replayed
    from the next step on.  Without CUDA every step runs eagerly over the
    same buffers."""

    def __init__(self, engine: "ImageGenEngine", rows: int, s_max: int):
        model, dev = engine.model, engine.device
        self.params, self.cfg = model.params, model.cfg
        self.rows, self.s_max = rows, s_max
        self.kv = janus_lib.init_kv_cache(model.params, model.cfg, rows, s_max,
                                          quantized=engine.kv_quant,
                                          layout="shbd", device=dev)
        self.mask = torch.zeros((rows, s_max), dtype=torch.int32, device=dev)
        self.length = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.step_kv = {**self.kv, "length": self.length}
        self.embeds = self.pos = self.hidden = self.graph = None
        self.launches = {}    # kernel launches a replay adds
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(dev)
            # step s's replay waits on the end of step s - 2's
            self.done = [torch.cuda.Event(), torch.cuda.Event()]

    def fresh_cache(self) -> dict:
        """The cache zeroed, as ``init_kv_cache`` makes it, for a prefill."""
        for t in self.kv.values():
            if isinstance(t, torch.Tensor):
                t.zero_()
        return dict(self.kv)

    def begin(self, window_mask: torch.Tensor, length: int) -> None:
        """A call's window mask (``s_max`` wide) and its prompt length."""
        self.mask.copy_(window_mask)
        self.length.fill_(length)

    def feed(self, embeds: torch.Tensor, pos: torch.Tensor) -> None:
        """The next step's inputs into the static ones."""
        if self.embeds is None:
            self.embeds, self.pos = torch.empty_like(embeds), torch.empty_like(pos)
        self.embeds.copy_(embeds)
        self.pos.copy_(pos)

    def _forward(self) -> torch.Tensor:
        hidden, _ = janus_lib.language_forward(
            self.params, self.cfg, self.embeds, self.mask, self.pos,
            kv_cache=self.step_kv)
        return hidden

    def step(self, step: int) -> torch.Tensor:
        """Run step ``step`` on the fed inputs → its hidden states.  Spans:
        ``image.wait`` (the host on step s - 2), ``image.trunk`` with
        ``graph`` 1 for a replay and 0 for an eager step, and
        ``image.capture``."""
        if self.graph is not None:
            done = self.done[step % 2]
            with span("image.wait"):
                done.synchronize()
            with span("image.trunk", graph=1):
                self.graph.replay()
                done.record()
                add_kernel_launches(self.launches)
            return self.hidden
        if not self.cuda:
            with span("image.trunk", graph=0):
                return self._forward()
        main = torch.cuda.current_stream(self.mask.device)
        with span("image.trunk", graph=0):
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                hidden = self._forward()
            main.wait_stream(self.stream)
            hidden.record_stream(main)
        with span("image.capture"):
            before = kernel_launches()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                self.hidden = self._forward()
            self.launches = {k: n - before[k] for k, n in kernel_launches().items()
                             if n != before[k]}
            add_kernel_launches({k: -n for k, n in self.launches.items()})
            self.graph = graph
        return hidden


def record_expert_span(expert_rows, parent=None) -> None:
    """A span ``image.experts`` holding the MoE counters of one call
    (:meth:`ImageGenEngine.take_expert_rows`); it reads them back from the
    device, so a caller places it after a sync the call already has."""
    rows, t_prompt, n_img, slots = expert_rows
    counters = deepseek_v2.expert_counters(rows.cpu().numpy(), t_prompt, n_img, slots)
    with span("image.experts", parent=parent, **counters):
        pass


class ImageGenEngine:
    def __init__(
        self,
        model: janus_lib.JanusModel,
        processor: Processor,
        cfg_weight: float = 5.0,
        temperature: float = 1.0,
        image_token_num: int = IMAGE_TOKEN_NUM_PER_IMAGE,
        img_size: int = IMG_SIZE,
        patch_size: int = PATCH_SIZE,
        kv_quant=False,
        decode_segments: int = 1,
        speculative: int = 0,
        kv_layout: str = None,
        batch_cap: int = None,
    ):
        self.model = model
        self.device = model.device
        self.processor = processor
        self.cfg_weight = float(cfg_weight)
        self.temperature = float(temperature)
        self.image_token_num = image_token_num
        self.img_size = img_size
        self.patch_size = patch_size
        self.kv_quant = parse_kv_quant(kv_quant)
        self.decode_segments = max(1, int(decode_segments))
        # speculative Jacobi decoding: window W (0 = sequential)
        self.speculative = int(speculative)
        self.kv_layout = kv_layout or "shbd"
        if self.kv_layout not in ("bshd", "bhsd", "shbd"):
            raise ValueError(f"kv_layout {self.kv_layout!r}: expected bshd | "
                             "bhsd | shbd")
        # the JAX engine's refusals (:96-111)
        if self.speculative:
            if self.kv_layout == "shbd":
                raise ValueError("speculative decoding needs per-row offsets "
                                 "(bshd/bhsd)")
            if self.kv_quant == "int4":
                raise ValueError("int4 KV does not support per-row offsets "
                                 "(SJD)")
        # a trunk with a cache of its own (an MLA/MoE trunk's latent cache,
        # a GDN/MoE trunk's K/V or a KDA/MLA/MoE trunk's latent cache beside
        # its recurrent states): model dtype, one layout, T = 1
        trunk = janus_lib.own_trunk(getattr(getattr(model, "cfg", None), "language", None))
        self.own_cache = trunk is not None
        if self.own_cache:
            if self.kv_quant:
                raise NotImplementedError(
                    f"kv_quant {self.kv_quant!r}: an int8/int4 "
                    f"{'K/V cache' if trunk is qwen3_next else 'latent cache'} is not "
                    f"ported for the {trunk.TRUNK}")
            if self.speculative or self.kv_layout != "shbd":
                raise NotImplementedError(
                    "speculative decoding and the bshd/bhsd layouts are not "
                    f"ported for the {trunk.TRUNK} (its cache takes one row of "
                    "every sequence a step)")
        # the decode-attention kernel reads the shbd model-dtype / int8
        # cache; the latent cache is read whole each step, as the kernel's is
        self.kernel_read = self.kv_layout == "shbd" and self.kv_quant != "int4"
        self.batch_cap = batch_cap
        # Jacobi iterations of the last speculative call
        self.last_sjd_iters = None
        # step_hook(step) is called on the host before each step's emit
        # (step 0 right after the prefill) of the sequential loop;
        # scripts/profile_torch_step3.py times and profiles it through it
        self.step_hook = None
        # the trunk graph of the last call that replayed one
        self._graph = None
        # a MoE trunk's last call: (its expert_rows on the device, prompt
        # bucket, image tokens, routed slots a step and layer where the
        # trunk holds an expert share, else 0), for :meth:`take_expert_rows`
        self._expert_rows = None

    def _replays_trunk(self) -> bool:
        """Whether the cached trunk step runs as a CUDA graph: on the card,
        on the decode kernel's cache (``shbd``, model-dtype or int8, MHA) or
        a trunk's own cache (MLA/MoE, GDN/MoE, KDA/MLA/MoE), outside SJD, in
        a model group of one (gloo's collectives cannot be captured)."""
        lc = self.model.cfg.language
        return (self.device.type == "cuda" and self.kernel_read
                and not self.speculative
                and (self.own_cache or lc.kv_heads == lc.num_heads)
                and mesh_lib.model_parallel_size() == 1)

    def take_expert_rows(self):
        """The last call's MoE counters, once: (``expert_rows`` on the
        device, prompt bucket, image tokens, routed slots a step and layer
        or 0), or None (a LLaMA trunk)."""
        out, self._expert_rows = self._expert_rows, None
        return out

    def _trunk_graph(self, rows: int, s_max: int) -> _TrunkGraph:
        """A graph of ``rows`` rows whose cache holds at least ``s_max``
        positions: the kept one, or a new one in its place (a batch of
        other rows, a longer prompt bucket)."""
        kept = self._graph
        if kept is None or kept.rows != rows or kept.s_max < s_max:
            # the kept graph's memory goes back before the new one is made
            kept = self._graph = None
            self._graph = _TrunkGraph(self, rows, s_max)
        return self._graph

    # ------------------------------------------------------------------
    # prompt construction (host)
    # ------------------------------------------------------------------
    def build_cfg_batch(self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenise prompts into the fused [2B, T] cond/uncond batch.

        The uncond rows set every prompt token to ``<pad>`` except the first
        (BOS) and last (``<begin_of_image>``), and — the reference's quirk
        (ospo/wrapper/image_generation.py:135-141) — their attention mask
        still covers the pad-masked positions."""
        tok = self.processor.tokenizer
        ids_list = [np.asarray(tok.encode(p), np.int32) for p in prompts]
        t_max = _bucket(max(len(x) for x in ids_list))
        b = len(prompts)
        tokens = np.full((2 * b, t_max), self.processor.pad_id, np.int32)
        mask = np.zeros((2 * b, t_max), np.int32)
        for i, ids in enumerate(ids_list):
            start = t_max - len(ids)
            tokens[i, start:] = ids
            tokens[b + i, start:] = ids
            tokens[b + i, start + 1 : -1] = self.processor.pad_id  # uncond
            mask[i, start:] = 1
            mask[b + i, start:] = 1
        return tokens, mask

    def _batch_bucket(self, b_real: int) -> int:
        """CFG-pair batch bucket: the next power of two, capped at the
        configured serving batch (ragged tails bucket below the cap)."""
        b = 1 << (b_real - 1).bit_length()
        if self.batch_cap:
            b = min(b, max(self.batch_cap, b_real))
        return b

    # ------------------------------------------------------------------
    # decode loop
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _segmented_decode(self, tokens: torch.Tensor, attn_mask: torch.Tensor,
                          step_fn: Callable) -> torch.Tensor:
        """The serving loop shared by sampling and the teacher-forced probe:
        prefill into the KV cache, then ``n_img - 1`` cached steps in
        ``decode_segments`` segments (:162-245).  ``step_fn(hidden_last,
        step, prompt_len) → (emit, embeds, pos)`` defines what each step
        emits and feeds next; emits are stacked on axis 1.  On the kernel's
        cache every step reads the whole window; on a plain read each
        segment's window covers the rows it writes (64-aligned).  Where
        :meth:`_replays_trunk`, the prefill writes the static cache of a
        :class:`_TrunkGraph`, whose replays make the cached steps, and the
        host keeps at most two steps in flight.  Spans: ``image.prefill``,
        each cached step's ``image.trunk`` (``graph`` 1 for a replay, 0
        for an eager step; with a graph also ``image.wait`` and
        ``image.capture``) and each ``step_fn``'s ``image.sample``."""
        params, cfg = self.model.params, self.model.cfg
        two_b, t_prompt = tokens.shape
        n_img = self.image_token_num
        s_max = t_prompt + n_img
        if self.kernel_read:
            s_max = ((s_max + 63) // 64) * 64
        graph = self._trunk_graph(two_b, s_max) if self._replays_trunk() else None
        if graph is not None:
            s_max = graph.s_max

        # a MoE prefill's routed rows: every position's top-k, each layer;
        # a GDN/MoE or KDA/MLA/MoE trunk's recurrent and conv state bytes
        lc = cfg.language
        attrs = {"moe_rows": two_b * t_prompt * lc.num_experts_per_tok * lc.n_moe} \
            if self.own_cache else {}
        if janus_lib.is_hybrid(lc):
            attrs["state_bytes"] = lc.state_bytes(two_b)
        with span("image.prefill", **attrs):
            kv = graph.fresh_cache() if graph is not None else \
                janus_lib.init_kv_cache(params, cfg, two_b, s_max,
                                        quantized=self.kv_quant,
                                        layout=self.kv_layout, device=self.device)
            hidden, kv = janus_lib.language_forward(
                params, cfg, janus_lib.embed_text(params, tokens), attn_mask,
                llama.positions_from_mask(attn_mask), kv_cache=kv, self_attn=True)
            prompt_len = attn_mask.sum(dim=-1)           # [2B] valid prompt tokens

            # mask over the whole cache: prompt part, all-ones image part
            # (causality excludes rows not written yet), zero alignment pad
            window_mask = torch.cat([
                attn_mask,
                torch.ones((two_b, n_img), dtype=torch.int32, device=self.device),
                torch.zeros((two_b, s_max - t_prompt - n_img), dtype=torch.int32,
                            device=self.device)], dim=-1).contiguous()
            if graph is not None:
                graph.begin(window_mask, kv["length"])

        def sample(hidden, step):
            with span("image.sample"):
                emit, embeds, pos = step_fn(hidden[:, -1], step, prompt_len)
                if graph is not None:
                    graph.feed(embeds, pos)
            return emit, embeds, pos

        hook = self.step_hook
        if hook:
            hook(0)
        emit, embeds, pos = sample(hidden, 0)
        outs = [emit]
        n_seg = min(self.decode_segments, max(1, (n_img - 1) // 64))
        start = 1
        for s in range(n_seg):
            end = 1 + (n_img - 1) * (s + 1) // n_seg
            window = s_max if self.kernel_read else \
                min(s_max, ((t_prompt + end + 63) // 64) * 64)
            for step in range(start, end):
                if graph is not None:
                    hidden = graph.step(step)
                else:
                    with span("image.trunk", graph=0):
                        hidden, kv = janus_lib.language_forward(
                            params, cfg, embeds, window_mask[:, :window], pos,
                            kv_cache=kv, attn_window=window)
                if hook:
                    hook(step)
                emit, embeds, pos = sample(hidden, step)
                outs.append(emit)
            start = end
        if "expert_rows" in kv:
            slots = two_b * lc.num_experts_per_tok if janus_lib.is_hybrid(lc) else 0
            self._expert_rows = (kv["expert_rows"].clone(), t_prompt, n_img, slots)
        return torch.stack(outs, dim=1)

    def _cfg_logits(self, hidden: torch.Tensor, cfg_weight: float):
        """Fused fp32 CFG logits of the last position ([2B, D] → [B, V]) or
        of every position ([2B, W, D] → [B, W, V])."""
        last = hidden.dim() == 2
        params = self.model.params
        # combined on this rank's vocab slice, then joined: half the rows
        logits = janus_lib.gen_logits(
            params, hidden[:, None] if last else hidden, join=False)
        b = logits.shape[0] // 2
        cond, uncond = logits[:b], logits[b:]
        fused = janus_lib.join_gen_vocab(
            params, (uncond + cfg_weight * (cond - uncond)).float())
        return fused[:, 0] if last else fused

    def _feed(self, tok: torch.Tensor, step: int, prompt_len: torch.Tensor):
        both = torch.cat([tok, tok])                           # [2B]
        embeds = janus_lib.prepare_gen_img_embeds(
            self.model.params, self.model.cfg, both[:, None])
        return embeds, (prompt_len + step)[:, None]            # pos [2B, 1]

    def _generate_tokens(self, tokens, attn_mask, generator: torch.Generator):
        def sample_step(hidden_last, step, prompt_len):
            fused = self._cfg_logits(hidden_last, self.cfg_weight)
            tok = mesh_lib.broadcast_model(
                sample_categorical(fused, self.temperature, generator))
            return (tok, *self._feed(tok, step, prompt_len))

        return self._segmented_decode(tokens, attn_mask, sample_step)

    def _fused_probs(self, hidden: torch.Tensor) -> torch.Tensor:
        fused = self._cfg_logits(hidden, self.cfg_weight)
        return torch.softmax(fused / max(self.temperature, 1e-6), dim=-1)

    @torch.inference_mode()
    def _generate_tokens_sjd(self, tokens, attn_mask,
                             generator: torch.Generator) -> torch.Tensor:
        """Speculative Jacobi CFG decode (:305-453): each model call
        verifies W drafted tokens at every row's own cache offset with
        speculative-sampling acceptance, so the output distribution is that
        of sequential sampling.  The JAX while-loop is a host loop here: it
        reads ``min(n_gen)`` once an iteration; all else stays on the
        device, every draw from ``generator``."""
        params, cfg = self.model.params, self.model.cfg
        dev = self.device
        two_b, t_prompt = tokens.shape
        b = two_b // 2
        n_img, W = self.image_token_num, self.speculative
        s_max = t_prompt + n_img + W          # drafts may overhang the end

        kv = janus_lib.init_kv_cache(params, cfg, two_b, s_max,
                                     quantized=self.kv_quant,
                                     layout=self.kv_layout, device=dev)
        hidden, kv = janus_lib.language_forward(
            params, cfg, janus_lib.embed_text(params, tokens), attn_mask,
            llama.positions_from_mask(attn_mask), kv_cache=kv, self_attn=True)
        prompt_len = attn_mask.sum(dim=-1)               # [2B] rotary base
        base_mask = torch.cat([attn_mask, torch.zeros(
            (two_b, s_max - t_prompt), dtype=attn_mask.dtype, device=dev)], -1)
        s_idx = torch.arange(s_max, device=dev)[None, :]
        rows = torch.arange(b, device=dev)
        wi = torch.arange(W, device=dev)[None, :]

        def draw(p):
            return sample_categorical(torch.log(p + 1e-30), 1.0, generator)

        # bootstrap: one sequential token, W drafts iid from p0
        p0 = self._fused_probs(hidden[:, -1])            # [B, V]
        last = mesh_lib.broadcast_model(draw(p0))
        q_probs = p0[:, None].expand(b, W, p0.shape[-1])
        drafts = mesh_lib.broadcast_model(draw(q_probs))
        # W spare columns take the writes past n_img (dropped at the end)
        out = torch.zeros((b, n_img + W), dtype=torch.long, device=dev)
        out[:, 0] = last
        n_gen = torch.ones((b,), dtype=torch.long, device=dev)
        iters = 0
        while int(n_gen.min()) < n_img:
            # the window's first query is last = out[n_gen - 1]: its cache
            # row is t_prompt + n_gen - 1 and its rotary position
            # prompt_len + n_gen - 1 (one off either way leaves row t_prompt
            # an all-zero row every later softmax attends)
            row2b = torch.cat([t_prompt + n_gen - 1] * 2)
            inputs = torch.cat([last[:, None], drafts[:, :W - 1]], dim=1)
            embeds = janus_lib.prepare_gen_img_embeds(
                params, cfg, torch.cat([inputs, inputs]))
            pos = (prompt_len + torch.cat([n_gen, n_gen]) - 1)[:, None] + wi
            mask = base_mask | ((s_idx >= t_prompt)
                                & (s_idx < (row2b + W)[:, None])).to(
                                    base_mask.dtype)
            hidden, kv = janus_lib.language_forward(
                params, cfg, embeds, mask, pos, kv_cache=kv,
                cache_positions=row2b)
            p = self._fused_probs(hidden)                # [B, W, V]

            p_d = p.gather(-1, drafts[..., None])[..., 0]
            q_d = q_probs.gather(-1, drafts[..., None])[..., 0]
            u = torch.rand((b, W), generator=generator, device=dev)
            acc = (u < p_d / q_d.clamp_min(1e-30)).long()
            n_acc = torch.cumprod(acc, dim=1).sum(dim=1)  # [B] 0..W

            # residual resample at the first rejected slot
            j = n_acc.clamp_max(W - 1)
            p_j, q_j = p[rows, j], q_probs[rows, j]
            resid = (p_j - q_j).clamp_min(0.0)
            resid = torch.where(resid.sum(-1, keepdim=True) > 1e-20, resid, p_j)
            t_res = draw(resid)

            c = torch.where(n_acc < W, n_acc + 1, W)    # committed count
            c = torch.where(n_gen >= n_img, 0, c)         # freeze done rows
            committed = torch.where(
                wi < n_acc[:, None], drafts,
                torch.where(wi == n_acc[:, None], t_res[:, None], 0))
            write = (wi < c[:, None]) & ((n_gen[:, None] + wi) < n_img)
            out.scatter_(1, torch.where(write, n_gen[:, None] + wi, n_img + wi),
                         committed)
            tail = committed.gather(1, (c - 1).clamp_min(0)[:, None])[:, 0]
            last = torch.where(c > 0, tail, last)

            # next drafts: each slot drawn on its own from this round's
            # distribution shifted by c (clamped to the last slot), so
            # q_probs stays the true proposal
            q_probs = p[rows[:, None], (c[:, None] + wi).clamp_max(W - 1)]
            drafts = draw(q_probs)
            n_gen = (n_gen + c).clamp_max(n_img)
            # model rank 0's state on every rank (tensor parallel)
            for t in (out, last, drafts, n_gen):
                mesh_lib.broadcast_model(t)
            iters += 1
        self.last_sjd_iters = iters
        return out[:, :n_img]

    def forced_cfg_logits(self, prompts: Sequence[str],
                          forced_tokens: np.ndarray) -> np.ndarray:
        """Teacher-forced CFG decode: the same serving loop, fed the given
        image tokens [B, n_img] instead of samples; returns the fused fp32
        CFG logits at every step [B, n_img, V] (the parity probe)."""
        tokens, mask = self._to_device(*self.build_cfg_batch(list(prompts)))
        forced = torch.as_tensor(np.asarray(forced_tokens), dtype=torch.long,
                                 device=self.device)

        def forced_step(hidden_last, step, prompt_len):
            fused = self._cfg_logits(hidden_last, self.cfg_weight)
            return (fused, *self._feed(forced[:, step], step, prompt_len))

        return self._segmented_decode(tokens, mask, forced_step).cpu().numpy()

    def _to_device(self, tokens: np.ndarray, mask: np.ndarray):
        return (torch.as_tensor(tokens, dtype=torch.long, device=self.device),
                torch.as_tensor(mask, dtype=torch.int32, device=self.device))

    @torch.inference_mode()
    def _decode_tokens(self, gen_tokens: torch.Tensor) -> torch.Tensor:
        latent = self.img_size // self.patch_size
        with span("image.vq_decode", device=True):
            pixels = vqgan.decode_code(self.model.params["gen_vision_model"],
                                       self.model.cfg.vq, gen_tokens,
                                       latent_hw=(latent, latent))
            # uint8 on the device (the reference's np.clip((dec+1)/2*255, 0,
            # 255), image_generation.py:177); the cast truncates
            return ((pixels.float() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def _generate_tokens_device(self, prompts: Sequence[str], seed: int = 0):
        """Bucketed generation, left on the device → (tokens [b_bucket,
        n_img], b_real); rows past b_real are padding duplicates."""
        b_real = len(prompts)
        prompts = list(prompts) + [prompts[-1]] * (self._batch_bucket(b_real) - b_real)
        tokens, mask = self._to_device(*self.build_cfg_batch(prompts))
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(seed))
        if self.speculative:
            return self._generate_tokens_sjd(tokens, mask, generator), b_real
        return self._generate_tokens(tokens, mask, generator), b_real

    def generate_tokens(self, prompts: Sequence[str], seed: int = 0) -> np.ndarray:
        """Prompts → sampled image tokens [B, n_img] on the host, without
        the VQ decode."""
        toks, b_real = self._generate_tokens_device(prompts, seed=seed)
        return toks[:b_real].cpu().numpy()

    def generate_images_device(self, prompts: Sequence[str],
                               seed: int = 0) -> torch.Tensor:
        """T2I-formatted prompts → uint8 [b_bucket, H, W, 3] on the device,
        without a host sync; rows past ``len(prompts)`` are padding."""
        toks, _ = self._generate_tokens_device(prompts, seed=seed)
        return self._decode_tokens(toks)

    def generate_images(self, prompts: Sequence[str], seed: int = 0) -> np.ndarray:
        """T2I-formatted prompts → uint8 images [B, H, W, 3] on the host."""
        imgs = self.generate_images_device(prompts, seed=seed)
        return imgs[: len(prompts)].cpu().numpy()

    def generate_from_raw_prompts(self, raw_prompts: Sequence[str],
                                  seed: int = 0) -> np.ndarray:
        """Raw prompts → uint8 images [B, H, W, 3] on the host, each prompt
        wrapped in the T2I template first (the inference CLI's entry)."""
        return self.generate_images(
            [t2i_prompt(self.processor, p) for p in raw_prompts], seed=seed)
