"""The port's Llama trunk against transformers' ``LlamaForCausalLM`` (the
model the reference builds, ``janus/models/modeling_vlm.py:218-219``) — the
second oracle of the trunk beside ``ospo_tpu``, as
``tests/test_llama_parity.py`` is for the JAX package.  CPU only (the card
machine has no transformers); skips without the package.

The HF state dict is mapped by the port's own checkpoint mapping
(``models/weights._port_llama`` with an empty prefix).
"""

import numpy as np
import pytest
import torch

from ospo_tpu_torch.models import llama as tl
from ospo_tpu_torch.models import weights

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)
# the first parallel CPU exp of a process can be off (ROADMAP §3): warm up
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))


class _StateDict:
    """The ``get(key, dtype)`` of a checkpoint reader over a state dict."""

    def __init__(self, sd):
        self.sd = sd

    def get(self, key, dtype=None):
        t = self.sd[key]
        return t.to(dtype or t.dtype)


@pytest.fixture(scope="module")
def setup():
    from transformers import LlamaConfig as HFConfig
    from transformers.models.llama.modeling_llama import LlamaForCausalLM

    cfg = tl.tiny_config(vocab_size=128, hidden_size=32, intermediate_size=64,
                         num_layers=2, num_heads=2, max_seq_len=128)
    hf_cfg = HFConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.kv_heads, rms_norm_eps=cfg.rms_norm_eps,
        rope_theta=cfg.rope_theta, max_position_embeddings=cfg.max_seq_len,
        attention_bias=False, mlp_bias=False, tie_word_embeddings=False,
        attn_implementation="eager")
    torch.manual_seed(0)
    hf = LlamaForCausalLM(hf_cfg).eval()
    sd = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    params = weights._port_llama(_StateDict(sd), cfg, "", lm_head=True,
                                 prefix="")
    return cfg, hf, params


def test_forward_logits_match(setup):
    """Left-padded batch: the port's logits equal transformers' on every
    valid position within 2e-4."""
    cfg, hf, params = setup
    rng = np.random.default_rng(0)
    b, t = 2, 12
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, t)))
    attn = torch.ones((b, t), dtype=torch.int64)
    attn[1, :4] = 0
    with torch.no_grad():
        ref = hf(input_ids=ids, attention_mask=attn).logits
        mask = attn.to(torch.int32)
        hidden, _ = tl.forward(params, cfg, tl.embed_tokens(params, ids), mask,
                               tl.positions_from_mask(mask))
        logits = tl.logits_from_hidden(params, hidden)
    valid = attn.bool()
    np.testing.assert_allclose(logits[valid].numpy(), ref[valid].numpy(),
                               atol=2e-4, rtol=2e-4)


def test_kv_cache_decode_matches_full_forward(setup):
    """Prefill into the ``shbd`` cache, then one cached step a token (the
    decode kernel's plain version on the CPU): the hidden states equal the
    full forward's, and its logits transformers'."""
    cfg, hf, params = setup
    rng = np.random.default_rng(1)
    b, t_prompt, t_total, smax = 2, 8, 14, 32
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, t_total)))
    attn = torch.ones((b, t_total), dtype=torch.int32)
    attn[0, :3] = 0
    with torch.no_grad():
        x = tl.embed_tokens(params, ids)
        pos = tl.positions_from_mask(attn)
        full, _ = tl.forward(params, cfg, x, attn, pos)
        ref = hf(input_ids=ids, attention_mask=attn.long()).logits

        cache = tl.init_kv_cache(cfg, b, smax)
        h_pre, cache = tl.forward(params, cfg, x[:, :t_prompt],
                                  attn[:, :t_prompt], pos[:, :t_prompt],
                                  kv_cache=cache, self_attn=True)
        valid = attn[:, :t_prompt].bool()
        np.testing.assert_allclose(h_pre[valid].numpy(),
                                   full[:, :t_prompt][valid].numpy(),
                                   atol=1e-5, rtol=1e-5)
        window = torch.zeros((b, smax), dtype=torch.int32)
        window[:, :t_prompt] = attn[:, :t_prompt]
        steps = []
        for step in range(t_prompt, t_total):
            window[:, step] = 1
            h, cache = tl.forward(params, cfg, x[:, step:step + 1], window,
                                  pos[:, step:step + 1], kv_cache=cache)
            steps.append(h[:, 0])
        h_dec = torch.stack(steps, dim=1)
        np.testing.assert_allclose(h_dec.numpy(),
                                   full[:, t_prompt:].numpy(),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(
            tl.logits_from_hidden(params, h_dec).numpy(),
            ref[:, t_prompt:].numpy(), atol=2e-4, rtol=2e-4)
