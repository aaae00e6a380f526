"""The port's safetensors reader and writer against the ``safetensors``
package, and its synthetic checkpoint writer against the JAX package's:
byte-equal directories for one configuration and seed, the same key list
at the 1B and 7B widths, and each package loading the other's directory to
the same weights and logits."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file as package_save_file

from ospo_tpu.models import janus as jjanus
from ospo_tpu.models import llama as jllama
from ospo_tpu.models import synthetic as jsyn
from ospo_tpu_torch.models import janus as tjanus
from ospo_tpu_torch.models import llama as tllama
from ospo_tpu_torch.models import synthetic as tsyn
from ospo_tpu_torch.models import weights as tweights
from ospo_tpu_torch.utils import safetensors_io

torch.set_num_threads(2)
# torch's CPU exp sets itself up on its first call (tests/test_torch_models.py)
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))


def _every_dtype():
    """A tensor of each dtype the port reads and writes, an empty one and
    a scalar."""
    g = torch.Generator().manual_seed(0)
    return {
        "w.bf16": torch.randn(5, 3, generator=g).bfloat16(),
        "a.f32": torch.randn(7, generator=g),
        "f16": torch.randn(3, 2, generator=g).half(),
        "f64": torch.randn(2, 2, generator=g, dtype=torch.float64),
        "i64": torch.arange(-3, 3, dtype=torch.int64),
        "i32": torch.arange(5, dtype=torch.int32).reshape(5, 1),
        "i16": torch.arange(-2, 2, dtype=torch.int16),
        "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
        "u8": torch.arange(9, dtype=torch.uint8),
        "mask": torch.tensor([True, False, True]),
        "empty": torch.zeros(0, 4, dtype=torch.int8),
        "scalar": torch.tensor(1.5),
    }


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_writer_is_byte_equal_to_the_package(tmp_path, metadata):
    tensors = _every_dtype()
    package_save_file(tensors, str(tmp_path / "ref.safetensors"),
                      metadata=metadata)
    safetensors_io.save_file(tensors, str(tmp_path / "port.safetensors"),
                             metadata=metadata)
    assert (tmp_path / "port.safetensors").read_bytes() == \
        (tmp_path / "ref.safetensors").read_bytes()


def test_reader_returns_the_package_tensors(tmp_path):
    path = str(tmp_path / "ref.safetensors")
    package_save_file(_every_dtype(), path, metadata={"format": "pt"})
    port = safetensors_io.SafeOpen(path)
    with safe_open(path, framework="pt") as ref:
        assert port.keys() == list(ref.keys())
        assert port.metadata() == ref.metadata()
        for key in ref.keys():
            got, want = port.get_tensor(key), ref.get_tensor(key)
            assert got.dtype == want.dtype and got.shape == want.shape, key
            assert torch.equal(got, want), key
    # views are writable, and a write stays in the process
    t = port.get_tensor("a.f32")
    t.add_(1.0)
    assert torch.equal(safetensors_io.SafeOpen(path).get_tensor("a.f32"),
                       _every_dtype()["a.f32"])


@pytest.mark.parametrize("shard_bytes", [1 << 30, 1 << 16])
def test_tiny_directory_is_byte_equal_to_jax(tmp_path, shard_bytes):
    """One shard, and shards of 64 KiB: the same files, byte for byte,
    ``config.json`` included."""
    jpath = jsyn.write_synthetic_checkpoint(
        str(tmp_path / "jax"), jjanus.tiny_janus_config(), seed=3,
        shard_bytes=shard_bytes)
    tpath = tsyn.write_synthetic_checkpoint(
        str(tmp_path / "port"), tjanus.tiny_janus_config(), seed=3,
        shard_bytes=shard_bytes)
    names = sorted(os.listdir(jpath))
    assert sorted(os.listdir(tpath)) == names and "config.json" in names
    assert len(names) == (2 if shard_bytes == 1 << 30 else 15)
    for name in names:
        assert filecmp.cmp(os.path.join(jpath, name), os.path.join(tpath, name),
                           shallow=False), name


@pytest.mark.parametrize("preset", ["1b", "7b"])
def test_key_shapes_match_jax_at_full_width(preset):
    jcfg = {"1b": jjanus.JANUS_PRO_1B, "7b": jjanus.JANUS_PRO_7B}[preset]
    tcfg = {"1b": tjanus.JANUS_PRO_1B, "7b": tjanus.JANUS_PRO_7B}[preset]
    assert list(tsyn.janus_key_shapes(tcfg)) == list(jsyn.janus_key_shapes(jcfg))
    assert tsyn._hf_config(tcfg) == jsyn._hf_config(jcfg)


def test_each_package_loads_the_others_directory(tmp_path):
    """The JAX package loads the port's tiny directory and the port the JAX
    package's (seed 5): the same weights (as ``test_load_janus_matches_jax_
    loader``) and the same text and image-head logits of a forward pass,
    within 1e-4 (fp32, two layers; ``test_llama_prefill_and_decode_step``'s
    tolerance)."""
    from ospo_tpu_torch.models.weights import from_jax_params

    tpath = tsyn.write_synthetic_checkpoint(
        str(tmp_path / "port"), tjanus.tiny_janus_config(), seed=5)
    jpath = jsyn.write_synthetic_checkpoint(
        str(tmp_path / "jax"), jjanus.tiny_janus_config(), seed=5)
    jmodel = jjanus.JanusModel.from_pretrained(tpath)
    tmodel = tweights.load_janus(jpath, device="cpu", lm_head=True)
    ref = from_jax_params(jax.tree.map(np.asarray, jmodel.params))
    for name in ("language_model", "gen_head", "gen_aligner"):
        flat_t, flat_r = _leaves(tmodel.params[name]), _leaves(ref[name])
        assert [p for p, _ in flat_t] == [p for p, _ in flat_r], name
        for (p, a), (_, b) in zip(flat_t, flat_r):
            torch.testing.assert_close(a, b, atol=0, rtol=0, msg=str(p))

    ids = np.random.default_rng(0).integers(0, 512, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    jcfg, tcfg = jmodel.cfg, tmodel.cfg
    jh, _ = jllama.forward(jmodel.params["language_model"], jcfg.language,
                           jjanus.embed_text(jmodel.params, jnp.asarray(ids)),
                           jnp.asarray(mask), jnp.asarray(pos))
    th, _ = tllama.forward(tmodel.params["language_model"], tcfg.language,
                           tjanus.embed_text(tmodel.params,
                                             torch.from_numpy(ids).long()),
                           torch.from_numpy(mask), torch.from_numpy(pos))
    pairs = [(tllama.logits_from_hidden(tmodel.params["language_model"], th),
              jllama.logits_from_hidden(jmodel.params["language_model"], jh)),
             (tjanus.gen_logits(tmodel.params, th),
              jjanus.gen_logits(jmodel.params, jh))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]
