"""Janus-Pro in PyTorch — counterpart of ``ospo_tpu/models/janus.py``:

  vision_model (SigLIP) → aligner (mlp_gelu) ─┐ understanding path
  gen_embed ([16384, 8] table) → gen_aligner ─┤ generation path
  gen_head (vision_head: hidden → 16384 logits) … gen_vision_model (VQ)
  language_model (Llama trunk) + lm_head ─────┘ shared trunk, text logits

Every part is built unless the caller drops it: ``lm_head`` (``drop_lm_head``
in step 3), the understanding tower (``drop_understanding``), and with
``drop_vision`` (the text steps) the VQ model, the generation heads and the
understanding tower.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ospo_tpu_torch.models import (deepseek_v2, kimi_linear, llama, projector, qwen3_next,
                                   vit, vqgan)
from ospo_tpu_torch.ops import quant
from ospo_tpu_torch.parallel import mesh as mesh_lib

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class JanusConfig:
    language: llama.LlamaConfig = dataclasses.field(
        default_factory=lambda: llama.LLAMA_7B)
    vision: vit.ViTConfig = dataclasses.field(
        default_factory=lambda: vit.SIGLIP_LARGE_384)
    vq: vqgan.VQConfig = dataclasses.field(default_factory=lambda: vqgan.VQ_16)
    gen_embed_dim: int = 8           # width of the gen_embed table rows
    aligner_depth: int = 2
    gen_aligner_depth: int = 2
    image_token_size: int = 16384    # VQ codebook size = image vocab
    gen_image_size: int = 384        # generated-image resolution
    dtype: Any = torch.bfloat16

    @property
    def n_embed(self) -> int:
        return self.language.hidden_size

    @property
    def image_size(self) -> int:
        """The image processor's size: the understanding tower's."""
        return self.vision.image_size

    @property
    def num_image_tokens(self) -> int:
        """Tokens per image on the understanding path (ViT patches)."""
        return self.vision.num_patches

    @property
    def vq_latent_side(self) -> int:
        return self.gen_image_size // self.vq.downsample_factor

    @property
    def num_gen_tokens(self) -> int:
        """Image tokens per generated image (576 for Janus-Pro @384)."""
        return self.vq_latent_side ** 2


JANUS_PRO_7B = JanusConfig()
JANUS_PRO_1B = JanusConfig(language=llama.LLAMA_1B)


def tiny_janus_config(vocab_size: int = 512, dtype=torch.float32) -> JanusConfig:
    """The JAX package's tiny Janus (2 layers, width 64; generation at 16px
    → 8×8 = 64 image tokens; the tiny ViT at 32px, patch 16, width 32, 2
    heads → 4 understanding tokens)."""
    return JanusConfig(
        language=llama.tiny_config(vocab_size=vocab_size, dtype=dtype),
        vision=vit.tiny_vit_config(dtype=dtype),
        vq=vqgan.tiny_vq_config(),
        gen_embed_dim=8,
        image_token_size=64,
        gen_image_size=16,
        dtype=dtype,
    )


# ---------------------------------------------------------------------------
# embeddings: text, the understanding path's image rows, generation ids
# ---------------------------------------------------------------------------


def embed_text(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return llama.embed_tokens(params["language_model"], input_ids)


def encode_images(params: Params, cfg: JanusConfig,
                  pixel_values: torch.Tensor) -> torch.Tensor:
    """Understanding path: pixels [N, H, W, 3] → aligned embeds [N, T2, D]."""
    feats = vit.forward(params["vision_model"], cfg.vision, pixel_values)
    return projector.mlp_projector(params["aligner"], feats)


def prepare_inputs_embeds(params: Params, cfg: JanusConfig,
                          input_ids: torch.Tensor,
                          pixel_values: Optional[torch.Tensor],
                          images_seq_mask: torch.Tensor,
                          images_emb_mask: torch.Tensor,
                          img_embeds: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Splice the aligned image embeddings into the text embeddings
    (``janus.py:120-167``): in each row, the k-th image slot of
    ``images_seq_mask`` [B, T] takes the k-th valid embedding of
    ``images_emb_mask`` [B, n, T2] in row order; a slot past the row's valid
    count takes zeros, as the JAX scatter/gather leaves it.
    ``img_embeds`` [B·n, T2, D] precomputed, or encoded from
    ``pixel_values`` [B, n, H, W, 3]."""
    b = input_ids.shape[0]
    n_img = images_emb_mask.shape[1]
    t2 = cfg.num_image_tokens
    if img_embeds is None:
        img_embeds = encode_images(params, cfg, pixel_values.reshape(
            b * n_img, *pixel_values.shape[2:]))
    flat = img_embeds.reshape(b, n_img * t2, -1)
    emb_mask = images_emb_mask.reshape(b, n_img * t2)
    # valid embeddings first, in order (a stable sort on "invalid")
    order = torch.sort(~emb_mask, dim=-1, stable=True).indices
    dense = torch.gather(flat, 1, order[..., None].expand(-1, -1, flat.shape[-1]))
    n_valid = emb_mask.sum(dim=-1, keepdim=True)
    slots = torch.arange(n_img * t2, device=flat.device)[None, :]
    dense = torch.where((slots < n_valid)[..., None], dense,
                        torch.zeros_like(dense))
    seq_rank = (torch.cumsum(images_seq_mask.to(torch.int32), dim=-1) - 1
                ).clamp(0, n_img * t2 - 1)
    gathered = torch.gather(
        dense, 1, seq_rank.long()[..., None].expand(-1, -1, dense.shape[-1]))
    text = embed_text(params, input_ids.clamp_min(0))
    return torch.where(images_seq_mask[..., None], gathered.to(text.dtype), text)


def prepare_gen_img_embeds(params: Params, cfg: JanusConfig,
                           image_ids: torch.Tensor) -> torch.Tensor:
    """Codebook ids → LM-space embeddings (``gen_aligner(gen_embed(ids))``)."""
    return projector.mlp_projector(params["gen_aligner"],
                                   params["gen_embed"][image_ids])


def gen_logits(params: Params, hidden: torch.Tensor,
               join: bool = True) -> torch.Tensor:
    """LM hidden states → image-token logits (fp32); a vocab-parallel head's
    slices are joined over the model group (:func:`join_gen_vocab`) unless
    ``join`` is False, so that CFG and sampling see whole rows."""
    logits = projector.vision_head(params["gen_head"], hidden)
    return join_gen_vocab(params, logits) if join else logits


def join_gen_vocab(params: Params, logits: torch.Tensor) -> torch.Tensor:
    """Image-token logits of this rank's vocab slice → whole rows (the
    identity for a whole head); anything elementwise over the vocab, the
    CFG combine, may come before."""
    if mesh_lib.is_vocab_shard(params["gen_head"]["head"]["w"]):
        return mesh_lib.all_gather_last(logits)
    return logits


def lm_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """LM hidden states → text logits (fp32)."""
    return llama.logits_from_hidden(params["language_model"], hidden)


def own_trunk(cfg):
    """The module of a trunk with a forward and a cache of its own for the
    language config ``cfg``: ``deepseek_v2`` (MLA/MoE), ``qwen3_next``
    (GDN/MoE) or ``kimi_linear`` (KDA/MLA/MoE); None for the LLaMA trunk."""
    for mod, test in ((deepseek_v2, deepseek_v2.is_mla), (qwen3_next, qwen3_next.is_hybrid),
                      (kimi_linear, kimi_linear.is_kimi)):
        if test(cfg):
            return mod
    return None


def is_hybrid(cfg) -> bool:
    """Whether the trunk keeps recurrent states beside its attention cache
    and holds an expert share of its MoE layers (``state_bytes``,
    ``held_range``): the GDN/MoE and KDA/MLA/MoE trunks."""
    return qwen3_next.is_hybrid(cfg) or kimi_linear.is_kimi(cfg)


def refuse_own_trunk(model, what: str) -> None:
    """``NotImplementedError`` naming ``what`` where ``model`` (a
    ``JanusModel``, or an engine test's stand-in that carries no config)
    runs a trunk of its own, which runs step 3's image generation only."""
    mod = own_trunk(getattr(getattr(model, "cfg", None), "language", None))
    if mod is not None:
        raise NotImplementedError(f"{what} is not ported for the {mod.TRUNK}: it runs "
                                  "step 3's image generation only")


def language_forward(params: Params, cfg: JanusConfig, *args, **kwargs):
    """The trunk's forward: ``llama.forward``, or the forward of a trunk of
    its own (:func:`own_trunk`: MLA/MoE, GDN/MoE or KDA/MLA/MoE), with the
    same arguments and result."""
    mod = own_trunk(cfg.language)
    if mod is not None:
        return mod.forward(params["language_model"], cfg.language, *args, **kwargs)
    return llama.forward(params["language_model"], cfg.language, *args, **kwargs)


def init_kv_cache(params: Params, cfg: JanusConfig, *args, **kwargs):
    """The trunk's KV cache for the heads this process holds (all of them,
    or its tensor-parallel share): ``llama.init_kv_cache``'s arguments; an
    MLA/MoE trunk's latent cache, a GDN/MoE trunk's K/V beside its recurrent
    states, a KDA/MLA/MoE trunk's latent cache beside its recurrent states."""
    mod = own_trunk(cfg.language)
    if mod is not None:
        return mod.init_kv_cache(cfg.language, *args, **kwargs)
    return llama.init_kv_cache(
        llama.local_config(cfg.language, params["language_model"]),
        *args, **kwargs)


# ---------------------------------------------------------------------------
# random init
# ---------------------------------------------------------------------------


class _Init:
    """Draws from one ``torch.Generator`` on the target device, one matrix
    at a time (values differ from the JAX package's random init)."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

    def normal(self, shape, std: float, dtype) -> torch.Tensor:
        w = torch.empty(shape, dtype=torch.float32, device=self.device)
        w.normal_(0.0, std, generator=self.gen)
        return w.to(dtype)

    def linear(self, cin: int, cout: int, dtype) -> Params:
        return {"w": self.normal((cout, cin), 0.02, dtype),
                "b": torch.zeros(cout, dtype=dtype, device=self.device)}

    def conv(self, k: int, cin: int, cout: int) -> Params:
        return {"w": self.normal((cout, cin, k, k), (2.0 / (k * k * cin)) ** 0.5,
                                 torch.float32),
                "b": torch.zeros(cout, device=self.device)}

    def gn(self, ch: int) -> Params:
        return {"scale": torch.ones(ch, device=self.device),
                "bias": torch.zeros(ch, device=self.device)}

    def res(self, cin: int, cout: int) -> Params:
        p = {"norm1": self.gn(cin), "conv1": self.conv(3, cin, cout),
             "norm2": self.gn(cout), "conv2": self.conv(3, cout, cout)}
        if cin != cout:
            p["nin_shortcut"] = self.conv(1, cin, cout)
        return p

    def attn(self, ch: int) -> Params:
        return {"norm": self.gn(ch), "q": self.conv(1, ch, ch),
                "k": self.conv(1, ch, ch), "v": self.conv(1, ch, ch),
                "proj_out": self.conv(1, ch, ch)}


def _init_language(ini: _Init, cfg: llama.LlamaConfig, quantize: str) -> Params:
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.dim_head, cfg.kv_heads * cfg.dim_head
    shapes = {"wq": (qd, d), "wk": (kvd, d), "wv": (kvd, d), "wo": (d, qd),
              "w_gate": (f, d), "w_up": (f, d), "w_down": (d, f)}
    layers: Params = {
        "attn_norm": torch.ones((n, d), dtype=cfg.dtype, device=ini.device),
        "mlp_norm": torch.ones((n, d), dtype=cfg.dtype, device=ini.device),
    }
    qfn = quant.quant_fn(quantize) if quantize else None
    for name in quant.QUANTIZABLE:
        rows, cols = shapes[name]
        if qfn:
            stacked = None
            for li in range(n):  # one model-dtype matrix alive at a time
                qw = qfn(ini.normal((rows, cols), 0.02, cfg.dtype))
                if stacked is None:
                    stacked = {k: torch.empty((n, *t.shape), dtype=t.dtype,
                                              device=ini.device)
                               for k, t in qw.items()}
                for k, t in qw.items():
                    stacked[k][li] = t
            layers[name] = stacked
        else:
            layers[name] = torch.stack([ini.normal((rows, cols), 0.02, cfg.dtype)
                                        for _ in range(n)])
    return {
        "embed": ini.normal((cfg.vocab_size, d), 0.02, cfg.dtype),
        "layers": layers,
        "final_norm": torch.ones(d, dtype=cfg.dtype, device=ini.device),
    }


def _init_vq_decoder(ini: _Init, cfg: vqgan.VQConfig) -> Params:
    ch, mults = cfg.base_ch, cfg.ch_mult
    n_levels = len(mults)
    block_in = ch * mults[-1]
    dec: Params = {"conv_in": ini.conv(3, cfg.z_channels, block_in)}
    dec["mid"] = [ini.res(block_in, block_in), ini.attn(block_in),
                  ini.res(block_in, block_in)]
    levels = []
    for i_level in reversed(range(n_levels)):
        block_out = ch * mults[i_level]
        level: Params = {"res": [], "attn": []}
        for _ in range(cfg.num_res_blocks + 1):
            level["res"].append(ini.res(block_in, block_out))
            block_in = block_out
            if i_level == n_levels - 1:
                level["attn"].append(ini.attn(block_in))
        if i_level != 0:
            level["upsample"] = ini.conv(3, block_in, block_in)
        levels.append(level)
    dec["levels"] = levels
    dec["norm_out"] = ini.gn(block_in)
    dec["conv_out"] = ini.conv(3, block_in, 3)
    cb = torch.empty((cfg.codebook_size, cfg.codebook_dim), device=ini.device)
    cb.uniform_(-1.0 / cfg.codebook_size, 1.0 / cfg.codebook_size,
                generator=ini.gen)
    if cfg.l2_norm_codebook:
        cb = cb / torch.linalg.vector_norm(cb, dim=-1, keepdim=True)
    return {"decoder": dec, "codebook": cb,
            "post_quant_conv": ini.conv(1, cfg.codebook_dim, cfg.z_channels)}


def _init_vq_encoder(ini: _Init, cfg: vqgan.VQConfig) -> Params:
    """The encoder side (``vqgan.init_params`` :111-135) and quant_conv."""
    ch, mults = cfg.base_ch, cfg.ch_mult
    n_levels = len(mults)
    enc: Params = {"conv_in": ini.conv(3, 3, ch)}
    levels = []
    block_in = ch
    for i in range(n_levels):
        block_out = ch * mults[i]
        level: Params = {"res": [], "attn": []}
        for _ in range(cfg.num_res_blocks):
            level["res"].append(ini.res(block_in, block_out))
            block_in = block_out
            if i == n_levels - 1:
                level["attn"].append(ini.attn(block_in))
        if i != n_levels - 1:
            level["downsample"] = ini.conv(3, block_in, block_in)
        levels.append(level)
    enc["levels"] = levels
    enc["mid"] = [ini.res(block_in, block_in), ini.attn(block_in),
                  ini.res(block_in, block_in)]
    enc["norm_out"] = ini.gn(block_in)
    enc["conv_out"] = ini.conv(3, block_in, cfg.z_channels)
    return {"encoder": enc,
            "quant_conv": ini.conv(1, cfg.z_channels, cfg.codebook_dim)}


def _init_understanding(ini: _Init, cfg: JanusConfig) -> Params:
    """The SigLIP tower and the aligner (``vit.init_params``,
    ``projector.init_mlp_projector``); the patch kernel OIHW."""
    vc, dt, e = cfg.vision, cfg.vision.dtype, cfg.n_embed
    d, hid, n, p = vc.width, vc.mlp_hidden, vc.depth, vc.patch_size
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=ini.device)  # noqa: E731
    ones = lambda *shape: torch.ones(shape, dtype=dt, device=ini.device)  # noqa: E731
    tower = {
        "patch_embed": {"w": ini.normal((d, 3, p, p), 0.02, dt), "b": zeros(d)},
        "pos_embed": ini.normal((1, vc.num_patches, d), 0.02, dt),
        "blocks": {
            "norm1_scale": ones(n, d), "norm1_bias": zeros(n, d),
            "wqkv": ini.normal((n, 3 * d, d), 0.02, dt), "bqkv": zeros(n, 3 * d),
            "wo": ini.normal((n, d, d), 0.02, dt), "bo": zeros(n, d),
            "norm2_scale": ones(n, d), "norm2_bias": zeros(n, d),
            "w1": ini.normal((n, hid, d), 0.02, dt), "b1": zeros(n, hid),
            "w2": ini.normal((n, d, hid), 0.02, dt), "b2": zeros(n, d),
        },
        "final_norm": {"scale": ones(d), "bias": zeros(d)},
    }
    aligner = {"layers": [ini.linear(d, e, cfg.dtype)] + [
        ini.linear(e, e, cfg.dtype) for _ in range(cfg.aligner_depth - 1)]}
    return {"vision_model": tower, "aligner": aligner}


@dataclasses.dataclass
class JanusModel:
    """Config + params (+ the device they live on)."""

    cfg: JanusConfig
    params: Params
    device: torch.device

    @classmethod
    def init(cls, cfg: JanusConfig, seed: int = 0, quantize=False,
             device: Optional[torch.device] = None, lm_head: bool = True,
             vision: bool = True, understanding: bool = True) -> "JanusModel":
        """Random init on ``device``; ``quantize`` (True = "int8", "w8a8",
        "int4", "int4g", "int4n") quantizes each trunk matrix as it is
        drawn, so the model-dtype trunk never exists whole.  The draws are the same in
        every mode.  ``lm_head=False`` leaves the text head out,
        ``understanding=False`` the SigLIP tower and the aligner,
        ``vision=False`` the VQ model, the generation heads and the
        understanding tower.  The head and the understanding tower come from
        generators of their own, so leaving them out changes no other weight
        of a seed."""
        if own_trunk(cfg.language) is not None:
            raise NotImplementedError("random init (JanusModel.init) is not "
                                      "ported for the MLA/MoE, GDN/MoE and KDA/MLA/MoE "
                                      "trunks: load them")
        mode = quant.quant_mode(quantize)
        device = torch.device(device or "cuda")
        ini = _Init(seed, device)
        e, dt = cfg.n_embed, cfg.dtype
        params = {"language_model": _init_language(ini, cfg.language, mode)}
        if lm_head:
            head = _Init(llama.fold_seed(seed, 1), device)
            params["language_model"]["lm_head"] = head.normal(
                (cfg.language.vocab_size, e), 0.02, dt)
        if not vision:
            return cls(cfg, params, device)
        if understanding:
            params.update(_init_understanding(
                _Init(llama.fold_seed(seed, 2), device), cfg))
        params.update({
            "gen_vision_model": _init_vq_decoder(ini, cfg.vq),
            "gen_aligner": {"layers": [ini.linear(cfg.gen_embed_dim, e, dt)] + [
                ini.linear(e, e, dt) for _ in range(cfg.gen_aligner_depth - 1)]},
            "gen_head": {"proj": ini.linear(e, e, dt),
                         "head": ini.linear(e, cfg.image_token_size, dt)},
            "gen_embed": ini.normal((cfg.image_token_size, cfg.gen_embed_dim),
                                    0.02, dt),
        })
        # drawn last, so the step-3 weights of a seed are those drawn before
        # the encoder existed
        params["gen_vision_model"].update(_init_vq_encoder(ini, cfg.vq))
        return cls(cfg, params, device)
