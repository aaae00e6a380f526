"""Janus-Pro generation path in PyTorch — counterpart of the generation side
of ``ospo_tpu/models/janus.py``:

  gen_embed ([16384, 8] table) → gen_aligner → language_model (Llama trunk)
  → gen_head (vision_head: hidden → 16384 logits) … gen_vision_model (VQ)

The understanding tower (SigLIP + aligner) and the text lm_head are not
built: step 3 never runs them (``drop_understanding`` / ``drop_lm_head``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ospo_tpu_torch.models import llama, projector, vqgan
from ospo_tpu_torch.ops import quant

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class JanusConfig:
    language: llama.LlamaConfig = dataclasses.field(
        default_factory=lambda: llama.LLAMA_7B)
    vq: vqgan.VQConfig = dataclasses.field(default_factory=lambda: vqgan.VQ_16)
    gen_embed_dim: int = 8           # width of the gen_embed table rows
    gen_aligner_depth: int = 2
    image_token_size: int = 16384    # VQ codebook size = image vocab
    gen_image_size: int = 384        # generated-image resolution
    dtype: Any = torch.bfloat16

    @property
    def n_embed(self) -> int:
        return self.language.hidden_size

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
    """The JAX package's tiny Janus (2 layers, width 64, 16px images →
    8×8 = 64 image tokens)."""
    return JanusConfig(
        language=llama.tiny_config(vocab_size=vocab_size, dtype=dtype),
        vq=vqgan.tiny_vq_config(),
        gen_embed_dim=8,
        image_token_size=64,
        gen_image_size=16,
        dtype=dtype,
    )


# ---------------------------------------------------------------------------
# generation-path functions
# ---------------------------------------------------------------------------


def embed_text(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return llama.embed_tokens(params["language_model"], input_ids)


def prepare_gen_img_embeds(params: Params, cfg: JanusConfig,
                           image_ids: torch.Tensor) -> torch.Tensor:
    """Codebook ids → LM-space embeddings (``gen_aligner(gen_embed(ids))``)."""
    return projector.mlp_projector(params["gen_aligner"],
                                   params["gen_embed"][image_ids])


def gen_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """LM hidden states → image-token logits (fp32)."""
    return projector.vision_head(params["gen_head"], hidden)


def language_forward(params: Params, cfg: JanusConfig, *args, **kwargs):
    return llama.forward(params["language_model"], cfg.language, *args, **kwargs)


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


def _init_language(ini: _Init, cfg: llama.LlamaConfig, quantize: bool) -> Params:
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.dim_head, cfg.kv_heads * cfg.dim_head
    shapes = {"wq": (qd, d), "wk": (kvd, d), "wv": (kvd, d), "wo": (d, qd),
              "w_gate": (f, d), "w_up": (f, d), "w_down": (d, f)}
    layers: Params = {
        "attn_norm": torch.ones((n, d), dtype=cfg.dtype, device=ini.device),
        "mlp_norm": torch.ones((n, d), dtype=cfg.dtype, device=ini.device),
    }
    for name in quant.QUANTIZABLE:
        rows, cols = shapes[name]
        if quantize:
            q = torch.empty((n, rows, cols), dtype=torch.int8, device=ini.device)
            s = torch.empty((n, rows), dtype=torch.float32, device=ini.device)
            for li in range(n):  # one bf16 matrix alive at a time
                qw = quant.quantize_matrix(ini.normal((rows, cols), 0.02, cfg.dtype))
                q[li], s[li] = qw["q"], qw["s"]
            layers[name] = {"q": q, "s": s}
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


@dataclasses.dataclass
class JanusModel:
    """Config + params (+ the device they live on)."""

    cfg: JanusConfig
    params: Params
    device: torch.device

    @classmethod
    def init(cls, cfg: JanusConfig, seed: int = 0, quantize=False,
             device: Optional[torch.device] = None) -> "JanusModel":
        """Random init on ``device``; ``quantize`` ("int8"/True) quantizes
        each trunk matrix as it is drawn, so the model-dtype trunk never
        exists whole."""
        if quantize not in (False, True, "int8"):
            raise NotImplementedError(
                f"quantize={quantize!r}: int4/w8a8 weights are queued in "
                "ROADMAP.md (slice 5, opt-in modes)")
        device = torch.device(device or "cuda")
        ini = _Init(seed, device)
        e, dt = cfg.n_embed, cfg.dtype
        params = {
            "language_model": _init_language(ini, cfg.language, bool(quantize)),
            "gen_vision_model": _init_vq_decoder(ini, cfg.vq),
            "gen_aligner": {"layers": [ini.linear(cfg.gen_embed_dim, e, dt)] + [
                ini.linear(e, e, dt) for _ in range(cfg.gen_aligner_depth - 1)]},
            "gen_head": {"proj": ini.linear(e, e, dt),
                         "head": ini.linear(e, cfg.image_token_size, dt)},
            "gen_embed": ini.normal((cfg.image_token_size, cfg.gen_embed_dim),
                                    0.02, dt),
        }
        return cls(cfg, params, device)
