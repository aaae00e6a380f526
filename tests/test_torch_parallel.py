"""Tensor parallel of the port (``ospo_tpu_torch/parallel/mesh.py``) on the
CPU — the port's side of ``tests/test_multichip.py``.

- The spec trees equal the JAX package's (a ``PartitionSpec`` read as the
  index of its ``model`` axis) in every weight mode; shard-then-gather is
  bit-equal.
- Two processes (gloo, ``scripts/run_multihost_torch.sh``) run
  ``tests/torch_tp_worker.py``'s cases on their shards at tp = 2; this
  process runs the same cases on the whole trees, and the trunk's forward
  also through ``ospo_tpu``.
- Step 3 in a world of four (dp 2 x tp 2) against dp 2 alone and one
  process.

Every subprocess has a timeout, and a ``finally`` kills what is left of it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ospo_tpu_torch.models import janus as tjanus
from ospo_tpu_torch.parallel import mesh as tmesh

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LAUNCHER = os.path.join(REPO, "scripts", "run_multihost_torch.sh")
FIXTURES = os.path.join(HERE, "fixtures", "examples")
MODES = ["", "int8", "w8a8", "int4", "int4g"]

torch.set_num_threads(2)
# the first parallel CPU exp of a process can be off (ROADMAP §3): warm up
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, HERE, env.get("PYTHONPATH", "")])
    env["PYTHON"] = sys.executable
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    return env


def _launch(nproc: int, *args: str, timeout: float = 240) -> str:
    proc = subprocess.Popen(["bash", LAUNCHER, str(nproc), *args], env=_env(),
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
    out = out.decode()
    assert proc.returncode == 0, out[-6000:]
    return out


def _model(cfg, mode="", seed=0):
    return tjanus.JanusModel.init(cfg, seed=seed, quantize=mode, device="cpu")


def _axis(spec):
    """A JAX PartitionSpec → the index of its model axis, or None."""
    spec = tuple(spec)
    return spec.index("model") if "model" in spec else None


def _jax_specs(params):
    import jax
    from jax.sharding import PartitionSpec

    from ospo_tpu.parallel import mesh as jmesh

    specs = jmesh.janus_param_specs(params)
    return jax.tree.map(_axis, specs,
                        is_leaf=lambda x: isinstance(x, PartitionSpec))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {path: tree}


@pytest.mark.parametrize("mode", MODES)
def test_spec_trees_match_jax(mode):
    """``janus_param_specs`` of a tree in each weight mode names the same
    sharded axis (or none) for every leaf as the JAX package's rules."""
    from torch_tp_worker import SERVE_CFG

    params = _model(SERVE_CFG, mode).params
    ours = _flat(tmesh.janus_param_specs(params))
    theirs = _flat(_jax_specs(params))
    assert ours == theirs
    assert ours[("language_model", "embed")] == 0
    assert ours[("gen_head", "head", "w")] == 0
    if mode:
        payload = "q4" if mode.startswith("int4") else "q"
        assert ours[("language_model", "layers", "wq", payload)] == 1
        assert ours[("language_model", "layers", "w_down", payload)] == 2


def test_lm_head_stub_spec_replicated():
    """``drop_lm_head``'s (1, 1) stub stays replicated, as in JAX, and the
    tree still shards."""
    params = _model(tjanus.tiny_janus_config()).params
    params["language_model"]["lm_head"] = torch.zeros((1, 1))
    assert tmesh.janus_param_specs(params)["language_model"]["lm_head"] is None
    assert _jax_specs(params)["language_model"]["lm_head"] is None
    shard = tmesh.shard_tree(params, 1, 2)
    assert shard["language_model"]["lm_head"] is params["language_model"]["lm_head"]


def test_lora_param_specs_match_jax():
    from ospo_tpu.parallel import mesh as jmesh

    names = ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
             "down_proj"]
    ours = tmesh.lora_param_specs(dict.fromkeys(names))
    theirs = jmesh.lora_param_specs(dict.fromkeys(names))
    assert ours == {n: {k: _axis(s) for k, s in ab.items()}
                    for n, ab in theirs.items()}


def _equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    return all(x.dtype == fb[k].dtype and torch.equal(x, fb[k])
               for k, x in fa.items())


@pytest.mark.parametrize("mode", MODES)
def test_shard_then_gather_is_bit_equal(mode):
    """Every rank's shard holds 1/tp of each sharded leaf (int4 rows
    repacked from their own halves); gathering the shards gives back the
    tree bit for bit."""
    from torch_tp_worker import SERVE_CFG

    params = _model(SERVE_CFG, mode).params
    shards = [tmesh.shard_tree(params, k, 2) for k in range(2)]
    assert _equal(tmesh.gather_tree(shards), params)
    wq = params["language_model"]["layers"]["wq"]
    local = shards[1]["language_model"]["layers"]["wq"]
    if mode.startswith("int4"):
        from ospo_tpu_torch.ops.quant import unpack_int4_halves

        # model rank 1 holds rows [F/2, F): the high nibbles of the whole
        # matrix's packed rows, repacked
        full = torch.cat(unpack_int4_halves(wq["q4"]), dim=-2)
        mine = torch.cat(unpack_int4_halves(local["q4"]), dim=-2)
        assert torch.equal(mine, full[:, full.shape[1] // 2:])
    elif mode:
        assert torch.equal(local["q"], wq["q"][:, wq["q"].shape[1] // 2:])
    else:
        assert torch.equal(local, wq[:, wq.shape[1] // 2:])


def test_int4g_row_parallel_needs_whole_groups():
    """A row-parallel int4g shard must keep whole scale groups: at hidden
    64 the group is 64 columns and tp = 2 would split it."""
    params = _model(tjanus.tiny_janus_config(), "int4g").params
    with pytest.raises(ValueError, match="multiple of the scale group"):
        tmesh.shard_tree(params, 0, 2)


# ---------------------------------------------------------------------------
# two processes against one
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    import torch_tp_worker as worker

    work = str(tmp_path_factory.mktemp("tp"))
    llama_tree = _model(tjanus.tiny_janus_config(), seed=1).params[
        "language_model"]
    janus_tree = _model(worker.SERVE_CFG).params
    torch.save(llama_tree, os.path.join(work, "llama.pt"))
    torch.save(janus_tree, os.path.join(work, "janus.pt"))
    out = _launch(2, "torch_tp_worker", work)
    assert out.count("# tp worker") == 2
    tp = torch.load(os.path.join(work, "tp_out.pt"), weights_only=False)
    ref = worker.run_cases(llama_tree, janus_tree)
    shapes = [json.load(open(os.path.join(work, f"shapes{r}.json")))
              for r in range(2)]
    return {"tp": tp, "ref": ref, "llama": llama_tree, "shapes": shapes}


def test_tp_forward_matches_one_process_and_jax(tp_run):
    """A tp = 2 Llama forward (num_heads = 4, two heads a rank) equals one
    process and ``ospo_tpu``'s single-device forward within 2e-4
    (``tests/test_multichip.py:70``)."""
    import jax.numpy as jnp

    from ospo_tpu.models import llama as jllama

    got = tp_run["tp"]["llama_logits"]
    np.testing.assert_allclose(got, tp_run["ref"]["llama_logits"],
                               atol=2e-4, rtol=2e-4)
    cfg = jllama.tiny_config(num_heads=4)
    params = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
                  else {n: jnp.asarray(t.numpy()) for n, t in v.items()})
              for k, v in tp_run["llama"].items()}
    ids = jnp.arange(24).reshape(2, 12) % cfg.vocab_size
    mask = jnp.ones((2, 12), jnp.int32)
    h, _ = jllama.forward(params, cfg, jllama.embed_tokens(params, ids), mask,
                          jllama.positions_from_mask(mask))
    np.testing.assert_allclose(
        got, np.asarray(jllama.logits_from_hidden(params, h)),
        atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("case", ["int8_shbd_2", "False_bshd_1"])
def test_tp_image_engine_matches_one_process(tp_run, case):
    """The CFG decode under tp = 2 — (int8 KV, ``shbd``, 2 segments) and
    (bf16, ``bshd``, 1): teacher-forced logits within 2e-4 and the same
    sampled tokens (``tests/test_multichip.py:135``)."""
    tp, ref = tp_run["tp"], tp_run["ref"]
    np.testing.assert_allclose(tp[f"forced_{case}"], ref[f"forced_{case}"],
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_array_equal(tp[f"tokens_{case}"], ref[f"tokens_{case}"])


def test_tp_ragged_batch_and_sjd(tp_run):
    """Three prompts (a ragged batch, padded inside the engine) and
    speculative Jacobi decoding (W = 4, ``bshd``) under tp = 2."""
    tp, ref = tp_run["tp"], tp_run["ref"]
    assert tp["ragged_tokens"].shape == (3, 64)
    np.testing.assert_array_equal(tp["ragged_tokens"], ref["ragged_tokens"])
    np.testing.assert_allclose(tp["ragged_forced"], ref["ragged_forced"],
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_array_equal(tp["sjd_tokens"], ref["sjd_tokens"])


@pytest.mark.parametrize("share", [True, False])
def test_tp_scoring_matches_one_process(tp_run, share):
    """Step 4b's scores under tp = 2, shared-prefix and unshared programs
    (``tests/test_multichip.py:168``, 1e-5)."""
    np.testing.assert_allclose(tp_run["tp"][f"scores_{share}"],
                               tp_run["ref"][f"scores_{share}"], atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "w8a8", "int4", "int4g"])
def test_tp_quantized_decodes_match_one_process(tp_run, mode):
    """Each weight mode sharded at tp = 2 decodes the tokens of one process
    (``tests/test_multichip.py:191``), its forced logits within 2e-4 (w8a8
    takes the abs-max of a row-parallel input over the group)."""
    tp, ref = tp_run["tp"], tp_run["ref"]
    np.testing.assert_array_equal(tp[f"w_{mode}_tokens"],
                                  ref[f"w_{mode}_tokens"])
    np.testing.assert_allclose(tp[f"w_{mode}_forced"], ref[f"w_{mode}_forced"],
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("key", ["text_ids", "text_ids_shared"])
def test_tp_greedy_text_ids_match_one_process(tp_run, key):
    """Greedy text ids under tp = 2, plain and shared-prefix programs
    (``tests/test_multichip.py:235``)."""
    np.testing.assert_array_equal(tp_run["tp"][key], tp_run["ref"][key])


def test_get_model_holds_a_shard_of_every_sharded_matrix(tp_run):
    """``get_model`` with ``tensor_parallel: 2`` (tiny, int8): each rank
    holds half of every sharded matrix — qkv, gate and up by rows, o and
    down by columns, the vocab tables by rows — and whole norms."""
    cfg = tjanus.tiny_janus_config()
    lc = cfg.language
    d, f, v = lc.hidden_size, lc.intermediate_size, lc.vocab_size
    L = lc.num_layers
    for rank, s in enumerate(tp_run["shapes"]):
        assert s["mesh"] == [1, 2, rank, 0]
        assert s["embed"] == [v // 2, d] and s["lm_head"] == [v // 2, d]
        assert s["gen_head"] == [cfg.image_token_size // 2, d]
        for name, (rows, cols) in {"wq": (d // 2, d), "wk": (d // 2, d),
                                   "wv": (d // 2, d), "wo": (d, d // 2),
                                   "w_gate": (f // 2, d), "w_up": (f // 2, d),
                                   "w_down": (d, f // 2)}.items():
            assert s[name] == {"q": [L, rows, cols], "s": [L, rows]}, name
        assert s["attn_norm"] == [L, d]


def test_step3_world_of_four(tmp_path):
    """Step 3's ``main`` in a world of four (dp 2 x tp 2): model rank 0 of
    each group writes each image once, the PNGs equal dp 2 alone's byte for
    byte, and the ``metadata.json`` files equal one process's."""
    from ospo_tpu_torch.config import build_config
    from ospo_tpu_torch.pipeline import step3

    common = ["--cfg_path", os.path.join(REPO, "configs", "step3.yaml"),
              "model_path=null", "model_preset=tiny", "device=cpu",
              f"data_path={FIXTURES}/step2/long_prompt.json", "e_idx=3",
              "batch_size=2"]

    def tree(root):
        return {os.path.relpath(os.path.join(d, n), root):
                open(os.path.join(d, n), "rb").read()
                for d, _, names in os.walk(root) for n in names}

    out = _launch(4, "ospo_tpu_torch.pipeline.step3", *common,
                  f"save_path={tmp_path}/tp", "tensor_parallel=2")
    stats = {}
    decoder = json.JSONDecoder()
    for rank in range(4):
        at = out.index(f"# step3 process {rank}/4: ")
        stats[rank] = decoder.raw_decode(out, out.index("{", at))[0]
    _launch(2, "ospo_tpu_torch.pipeline.step3", *common,
            f"save_path={tmp_path}/dp")
    step3.main(build_config(common[1], overrides=common[2:] + [
        f"save_path={tmp_path}/one"], use_cli=False))

    tp, dp, one = (tree(os.path.join(tmp_path, k)) for k in ("tp", "dp", "one"))
    pngs = sorted(k for k in tp if k.endswith(".png"))
    assert len(pngs) == 18 and tp == dp
    assert sorted(k for k in one if k.endswith(".png")) == pngs
    meta = {k: json.loads(v) for k, v in tp.items() if k.endswith(".json")}
    assert len(meta) == 6 and meta == {
        k: json.loads(v) for k, v in one.items() if k.endswith(".json")}
    # model ranks 1 and 3 draw what their groups draw and write nothing
    assert [stats[r]["written"] for r in range(4)] == [12, 0, 6, 0]
    assert stats[0]["images"] == stats[1]["images"] == 12


def test_parallel_layout_rules(monkeypatch):
    """``data_parallel`` x ``tensor_parallel`` must equal the processes the
    mesh spans; step 5 refuses tensor parallel, naming the ROADMAP item."""
    from ospo_tpu_torch.pipeline import model_factory
    from ospo_tpu_torch.train import trainer as trainer_mod

    monkeypatch.setattr(model_factory, "process_count", lambda: 4)
    base = {"model_preset": "tiny", "device": "cpu", "tensor_parallel": 2}
    for over in ({}, {"data_parallel": 2}, {"mesh_scope": "global"}):
        model_factory._reject_unported({**base, **over})
    for over in ({"data_parallel": 1}, {"tensor_parallel": 3},
                 {"data_parallel": 4}):
        with pytest.raises(ValueError, match="run_multihost_torch.sh"):
            model_factory._reject_unported({**base, **over})
    with pytest.raises(NotImplementedError, match="ROADMAP.md .*item 4b"):
        trainer_mod.refuse_tensor_parallel(2)
    model = _model(tjanus.tiny_janus_config())
    with pytest.raises(NotImplementedError, match="tensor_parallel"):
        trainer_mod.SimPOTrainer(
            {"model": {"tensor_parallel": 2}, "device": "cpu",
             "lora": {"lora_rank": 4, "lora_alpha": 8}}, model, None)
