"""The cached trunk step at a cache length held in device memory, and the
image engine's trunk graph, on the CPU.

``llama.forward``'s T = 1 step over an ``shbd`` cache whose ``length`` is a
tensor (the step a CUDA graph captures) against the step at a host length
and against the JAX package's; ``_write_kv`` at a device index against the
slice write; which engines replay the trunk; and the engine's loop over the
graph's static buffers (run eagerly here: the CPU has no CUDA graphs)
against the eager loop.  ``tests/test_torch_cuda.py`` holds the capture and
the replay on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ospo_tpu.models import llama as jllama
from ospo_tpu_torch.config import Config
from ospo_tpu_torch.engine.image_engine import ImageGenEngine
from ospo_tpu_torch.models import llama as tllama
from ospo_tpu_torch.models.weights import from_jax_params
from ospo_tpu_torch.parallel import mesh as mesh_lib
from ospo_tpu_torch.processing import t2i_prompt

torch.set_num_threads(2)
# the first parallel torch.exp of a process can come out ~1e-4 off in the
# worker thread's share (MKL VML set-up); make that call here
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))


def _to(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_device_length_step_equals_the_host_step_and_jax(kv):
    """Prefill, then two cached T = 1 steps three ways: the port at a host
    length, the port at a device length (advanced in place by each step),
    and the JAX package.  The two port steps agree bit for bit, hidden
    states and every cache tensor; JAX within 1e-4 (fp32 weights, int8
    cache) or 3e-2 (bf16 weights and cache: bf16 products in two
    orders)."""
    bf16 = kv == "bf16"
    jdtype, tdtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    cfg_j, cfg_t = jllama.tiny_config(dtype=jdtype), tllama.tiny_config(dtype=tdtype)
    jp = jllama.init_params(jllama.tiny_config(), jax.random.PRNGKey(0))
    tp = _to(from_jax_params({"language_model": jax.tree.map(np.asarray, jp)})
             ["language_model"], tdtype)
    jp = jax.tree.map(lambda x: x.astype(jdtype), jp)
    quantized = "int8" if kv == "int8" else False
    rng = np.random.default_rng(1)
    B, T, S = 3, 12, 20
    x = rng.standard_normal((B, T, cfg_t.hidden_size), np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, :4] = 0
    pos = np.array(jllama.positions_from_mask(jnp.asarray(mask)))
    window = np.concatenate([mask, np.ones((B, S - T), np.int32)], axis=1)

    host = tllama.init_kv_cache(cfg_t, B, S, quantized=quantized)
    _, host = tllama.forward(tp, cfg_t, torch.from_numpy(x), torch.from_numpy(mask),
                             torch.from_numpy(pos), kv_cache=host, self_attn=True)
    dev = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in host.items()}
    length = torch.tensor([T], dtype=torch.int32)
    dev["length"] = length
    jc = jllama.init_kv_cache(cfg_j, B, S, quantized=quantized, layout="shbd")
    _, jc = jllama.forward(jp, cfg_j, jnp.asarray(x, jdtype), jnp.asarray(mask),
                           jnp.asarray(pos), kv_cache=jc, self_attn=True,
                           cache_layout="shbd")
    for step in range(2):
        xd = rng.standard_normal((B, 1, cfg_t.hidden_size), np.float32)
        pd = (mask.sum(-1, keepdims=True) + step).astype(np.int32)
        args = (torch.from_numpy(xd), torch.from_numpy(window), torch.from_numpy(pd))
        h_host, host = tllama.forward(tp, cfg_t, *args, kv_cache=host)
        h_dev, dev = tllama.forward(tp, cfg_t, *args, kv_cache=dev)
        h_jax, jc = jllama.forward(jp, cfg_j, jnp.asarray(xd, jdtype), jnp.asarray(window),
                                   jnp.asarray(pd), kv_cache=jc, cache_layout="shbd")
        assert host["length"] == T + step + 1
        assert dev["length"] is length and length.tolist() == [T + step + 1]
        assert torch.equal(h_host, h_dev)
        for key in ("k", "v", "k_s", "v_s"):
            if key in host:
                assert torch.equal(host[key], dev[key]), key
        tol = 3e-2 if bf16 else 1e-4
        np.testing.assert_allclose(h_dev.float().numpy(),
                                   np.asarray(h_jax.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("payload", [False, "int8"])
def test_write_kv_at_a_device_index_equals_the_slice_write(payload):
    """One fresh row per layer written at a device index (``index_copy_``
    along S) equals the slice write at the same host index, payload and
    scales; a device index takes one row of an ``shbd`` cache only."""
    cfg = tllama.tiny_config()
    B, S, p = 3, 16, 9
    g = torch.Generator().manual_seed(0)
    at_host = tllama.init_kv_cache(cfg, B, S, quantized=payload)
    at_dev = tllama.init_kv_cache(cfg, B, S, quantized=payload)
    for li in range(cfg.num_layers):
        k, v = (torch.randn((B, 1, cfg.num_heads, cfg.dim_head), generator=g)
                for _ in range(2))
        tllama._write_kv(at_host, li, p, k, v)
        tllama._write_kv(at_dev, li, torch.tensor([p]), k, v)
    for key in ("k", "v", "k_s", "v_s"):
        if key in at_host:
            assert torch.equal(at_host[key], at_dev[key]), key
            assert at_dev[key][:, p].abs().sum() > 0
    two = torch.zeros((B, 2, cfg.num_heads, cfg.dim_head))
    with pytest.raises(ValueError, match="one row"):
        tllama._write_kv(at_dev, 0, torch.tensor([p]), two, two)
    bshd = tllama.init_kv_cache(cfg, B, S, quantized=payload, layout="bshd")
    with pytest.raises(ValueError, match="one row"):
        tllama._write_kv(bshd, 0, torch.tensor([p]), two[:, :1], two[:, :1])


def test_a_device_length_takes_only_the_kernel_step():
    """A device cache length outside the decode kernel's T = 1 step (a
    T > 1 step, a prefill) is refused."""
    cfg = tllama.tiny_config()
    jp = jllama.init_params(jllama.tiny_config(), jax.random.PRNGKey(0))
    tp = from_jax_params({"language_model": jax.tree.map(np.asarray, jp)})["language_model"]
    cache = tllama.init_kv_cache(cfg, 2, 16, quantized="int8")
    cache["length"] = torch.tensor([4], dtype=torch.int32)
    x = torch.zeros((2, 2, cfg.hidden_size))
    ones = torch.ones((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="device cache length"):
        tllama.forward(tp, cfg, x, ones, torch.zeros((2, 2), dtype=torch.int32),
                       kv_cache=cache)
    with pytest.raises(ValueError, match="device cache length"):
        tllama.forward(tp, cfg, x, ones[:, :2], torch.zeros((2, 2), dtype=torch.int32),
                       kv_cache=cache, self_attn=True)


@pytest.fixture(scope="module")
def tiny():
    from ospo_tpu_torch.pipeline.model_factory import get_model

    model, _, processor = get_model(Config.from_nested(
        {"model_path": None, "model_preset": "tiny", "device": "cpu"}))
    return model, processor


def _engine(tiny, **kw):
    model, proc = tiny
    args = dict(image_token_num=model.cfg.num_gen_tokens,
                img_size=model.cfg.gen_image_size,
                patch_size=model.cfg.vq.downsample_factor)
    return ImageGenEngine(model, proc, **{**args, **kw})


@pytest.mark.parametrize("device,layout,kv_quant,speculative,group,want", [
    ("cuda", "shbd", "int8", 0, 1, True),
    ("cuda", "shbd", False, 0, 1, True),
    ("cpu", "shbd", "int8", 0, 1, False),
    ("cuda", "bshd", "int8", 0, 1, False),
    ("cuda", "bhsd", False, 0, 1, False),
    ("cuda", "shbd", "int4", 0, 1, False),
    ("cuda", "bshd", False, 4, 1, False),
    ("cuda", "shbd", "int8", 0, 2, False),
])
def test_the_engine_replays_the_trunk_only_where_a_graph_holds(
        tiny, monkeypatch, device, layout, kv_quant, speculative, group, want):
    """A graph on the card over the decode kernel's cache, in a model group
    of one; the eager loop on the CPU, on the plain reads (``bshd``,
    ``bhsd``, an int4 cache), under SJD and in a model group of two."""
    engine = _engine(tiny, kv_layout=layout, kv_quant=kv_quant, speculative=speculative)
    engine.device = torch.device(device)
    monkeypatch.setattr(mesh_lib, "model_parallel_size", lambda: group)
    assert engine._replays_trunk() is want


PROMPTS = ["A red cube on top of a blue sphere", "Two cats"]


@pytest.mark.parametrize("kv_quant", [False, "int8"])
def test_the_loop_over_the_graph_buffers_equals_the_eager_loop(tiny, kv_quant):
    """The engine's loop over a trunk graph's static buffers (the prefill
    into the static cache, the device length, the fed embeds and
    positions), run eagerly as the CPU must, gives the eager loop's forced
    logits bit for bit over three calls (the second's longer prompt makes a
    larger cache; the third reuses it), and the same sampled ids; the
    default engine on the CPU keeps no graph."""
    model, proc = tiny
    eager = _engine(tiny, kv_quant=kv_quant)
    graph = _engine(tiny, kv_quant=kv_quant)
    graph._replays_trunk = lambda: True
    n_img = eager.image_token_num
    rng = np.random.default_rng(3)
    s_maxes = []
    for prompts in (PROMPTS, [PROMPTS[0], "a long prompt " * 8], PROMPTS):
        prompts = [t2i_prompt(proc, p) for p in prompts]
        forced = rng.integers(0, model.cfg.image_token_size, (2, n_img))
        assert np.array_equal(graph.forced_cfg_logits(prompts, forced),
                              eager.forced_cfg_logits(prompts, forced))
        s_maxes.append(graph._graph.s_max)
    assert s_maxes[0] < s_maxes[1] == s_maxes[2]
    prompts = [t2i_prompt(proc, p) for p in PROMPTS]
    assert (graph.generate_tokens(prompts, seed=7)
            == eager.generate_tokens(prompts, seed=7)).all()
    assert eager._graph is None
