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


def _start(nproc: int, *args: str) -> subprocess.Popen:
    return subprocess.Popen(["bash", LAUNCHER, str(nproc), *args], env=_env(),
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True)


def _wait(proc: subprocess.Popen, timeout: float = 240) -> str:
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
    out = out.decode()
    assert proc.returncode == 0, out[-6000:]
    return out


def _launch(nproc: int, *args: str, timeout: float = 240) -> str:
    return _wait(_start(nproc, *args), timeout)


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
    mesh spans, in the factory and in step 5's trainer; the trainer accepts
    tp = 2 on a model sharded over model groups of 2, and keeps this rank's
    shard of the whole adapter tree."""
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

    model = _model(tjanus.tiny_janus_config())
    lora = {"lora_rank": 4, "lora_alpha": 8}
    monkeypatch.setattr(trainer_mod, "process_count", lambda: 4)
    for over in ({"data_parallel": 1}, {"data_parallel": 4},
                 {"tensor_parallel": 3}):
        with pytest.raises(ValueError, match="must equal the 4 training"):
            trainer_mod.SimPOTrainer(
                {"model": {"tensor_parallel": 2, **over}, "device": "cpu",
                 "lora": lora}, model, None)
    # dp x tp = world, but the model is whole
    with pytest.raises(ValueError, match="not sharded"):
        trainer_mod.SimPOTrainer(
            {"model": {"tensor_parallel": 2}, "device": "cpu", "lora": lora},
            model, None)
    # model rank 1 of data index 1 in a world of four: this rank's shard of
    # the model and of the adapters
    mesh = tmesh.Mesh(data=2, model=2, rank=3)
    monkeypatch.setattr(tmesh, "_CURRENT", mesh)
    monkeypatch.setattr(trainer_mod, "process_index", lambda: 3)
    model.params = tmesh.shard_janus_params(model.params, mesh)
    for dp in (0, 2):
        t = trainer_mod.SimPOTrainer(
            {"model": {"tensor_parallel": 2, "data_parallel": dp},
             "device": "cpu", "lora": lora}, model, None)
        assert (t.tp, t.dp, t.data_index, t.is_main) == (2, 2, 1, False)
        whole = trainer_mod.lora_lib.init_lora(model.cfg.language, t.lora_cfg,
                                               t.seed)
        q, o = t.trainable["q_proj"], t.trainable["o_proj"]
        assert torch.equal(q["a"].detach(), whole["q_proj"]["a"])
        assert torch.equal(q["b"].detach(), whole["q_proj"]["b"][..., 32:])
        assert torch.equal(o["a"].detach(), whole["o_proj"]["a"][:, 32:])
        assert torch.equal(o["b"].detach(), whole["o_proj"]["b"])
        assert sorted(t._partial) == sorted(
            [f"{n}/a" for n in ("q_proj", "k_proj", "v_proj", "gate_proj",
                                "up_proj")] + ["o_proj/b", "down_proj/b"])


# ---------------------------------------------------------------------------
# step 5 under tensor parallel (tests/test_multichip.py:40 and :248)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp_train(tmp_path_factory):
    """Two processes run ``torch_tp_worker.run_train_cases`` at tp = 2 while
    this one runs them on the whole model, and the JAX package's unsharded
    LoRA and full-fine-tune steps run on the same weights, adapters (B
    non-zero) and batch (``tests/test_torch_train.py``'s helpers)."""
    import jax
    import jax.numpy as jnp
    import optax

    import test_torch_train as tt
    import torch_tp_worker as worker
    from ospo_tpu.train import checkpoint as jckpt
    from ospo_tpu.train import lora as jlora
    from ospo_tpu_torch.models import llama as tllama

    work = str(tmp_path_factory.mktemp("tp_train"))
    jl = tt._jax_lora_step(tmp_path_factory.mktemp("jl"))
    jf = tt._jax_full_step(tmp_path_factory.mktemp("jf"))
    resume = tt._np_lora(tllama.tiny_config(), 4, 18)
    jtree = jax.tree.map(jnp.asarray, resume)
    jpath = jckpt.save_checkpoint(
        os.path.join(work, "jax"), 3, jtree,
        jlora.LoraConfig(rank=4, alpha=8, dropout=0.0),
        opt_state=optax.adamw(1e-3).init(jtree))
    inp = {"lora_conf": tt._trainer_config(work, "flash"),
           "full_conf": tt._full_config(work, "flash", {"gen_head": False}),
           "lora_params": jl["params"], "full_params": jf["params"],
           "lora": jl["lora"], "batch": tt._batch(), "batch2": tt._batch(16),
           "jax_ckpt": jpath}
    torch.save(inp, os.path.join(work, "train.pt"))
    proc = _start(2, "torch_tp_worker", work, "train")
    try:
        one = worker.run_train_cases(inp, os.path.join(work, "one"))
    finally:
        out = _wait(proc)
    assert out.count("# tp train worker") == 2
    tp = [torch.load(os.path.join(work, f"train_out{r}.pt"), weights_only=False)
          for r in range(2)]
    return {"tp": tp, "one": one, "jax_lora": jl, "jax_full": jf,
            "resume": resume}


def _rel(got: dict, ref: dict) -> float:
    """The worst leaf's max|got − ref| / max|ref| over ``ref``'s paths."""
    assert set(got) == set(ref), sorted(set(got) ^ set(ref))
    return max(float(np.abs(np.asarray(got[k], np.float64) - ref[k]).max())
               / max(float(np.abs(ref[k]).max()), 1e-30) for k in ref)


def _jax_flat(tree) -> dict:
    from ospo_tpu_torch.train.optim import leaves

    return {p: np.asarray(x, np.float64) for p, x in leaves(tree)}


@pytest.mark.parametrize("case", ["lora", "lora_dropout"])
def test_tp_lora_step_matches_one_process_and_jax(tp_train, case):
    """A LoRA micro-batch at tp = 2 (B non-zero, so every A has a
    gradient; the column-parallel A and row-parallel B are summed over the
    model group): the loss and ``grad_norm`` within 1e-5 relative and every
    gathered gradient leaf within 1e-5 max|ref| of one process — with
    dropout too (a row-parallel adapter takes its columns of the row's
    mask) — and, without dropout, of the JAX package's unsharded
    ``SimPOTrainer._step`` (``tests/test_multichip.py:248``)."""
    refs = [tp_train["one"][case]]
    if case == "lora":
        jm = tp_train["jax_lora"]["metrics"]
        refs.append((jm["loss"], jm["grad_norm"],
                     _jax_flat(tp_train["jax_lora"]["grads"])))
    for rank, out in enumerate(tp_train["tp"]):
        loss, norm, grads = out[case]
        for ref_loss, ref_norm, ref_grads in refs:
            np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
            np.testing.assert_allclose(norm, ref_norm, rtol=1e-5)
            err = _rel(grads, ref_grads)
            assert err <= 1e-5, (rank, err)


def test_tp_full_finetune_step_matches_one_process_and_jax(tp_train):
    """A full fine-tune step at tp = 2 (the language model and the gen head
    trained on their shards, moments per shard): the loss within 1e-5 and
    the updated ``language_model.layers.wq``, gathered, within 2e-5 of one
    process and of the JAX package's unsharded step
    (``tests/test_multichip.py:40``)."""
    jax_full = tp_train["jax_full"]
    jax_wq = np.asarray(jax_full["updated"]["language_model"]["layers"]["wq"])
    for out in tp_train["tp"]:
        for loss, wq in ((tp_train["one"]["full_metrics"]["loss"],
                          tp_train["one"]["full_wq"]),
                         (jax_full["metrics"]["loss"], jax_wq)):
            np.testing.assert_allclose(out["full_metrics"]["loss"], loss,
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(out["full_wq"], wq, atol=2e-5,
                                       rtol=2e-5)
        np.testing.assert_allclose(out["full_metrics"]["grad_norm"],
                                   jax_full["metrics"]["grad_norm"], rtol=1e-5)


def _replicated(out: dict, one: dict) -> list:
    """The paths of ``out``'s leaves that are whole (replicated), by their
    shape against one process's."""
    return [p for p, t in out.items() if t.shape == one[p].shape]


@pytest.mark.parametrize("mode", ["lora", "full"])
def test_tp_replicas_stay_bit_equal(tp_train, mode):
    """After two steps, every replicated leaf — the column-parallel A and
    row-parallel B; in full fine-tune the norms and ``gen_head.proj`` — and
    its moments are bit-equal on both ranks, and every other leaf is a
    half."""
    one = tp_train["one"][f"{mode}_local"]
    r0, r1 = (out[f"{mode}_local"] for out in tp_train["tp"])
    rep = _replicated(r0["trained"], one["trained"])
    assert rep and len(rep) < len(one["trained"])
    if mode == "lora":
        assert sorted(rep) == sorted(
            [f"{n}/a" for n in ("q_proj", "k_proj", "v_proj", "gate_proj",
                                "up_proj")] + ["o_proj/b", "down_proj/b"])
    else:
        assert {"language_model/layers/attn_norm", "language_model/final_norm",
                "gen_head/proj/w"} <= set(rep)
    for p, t in r0["trained"].items():
        if p in rep:
            assert torch.equal(t, r1["trained"][p]), p
            for part in ("mu", "nu"):
                k = f"{part}/{p}"
                assert torch.equal(r0["opt"][k], r1["opt"][k]), k
        else:
            assert 2 * t.numel() == one["trained"][p].numel(), p


def _joined(ranks: list, one: dict) -> dict:
    """Each leaf of the ranks' local trees joined whole: a replicated one
    as rank 0 holds it, a half concatenated on the axis it was cut."""
    out = {}
    for p, ref in one.items():
        a, b = (r[p] for r in ranks)
        if a.shape == ref.shape:
            out[p] = a
            continue
        axis = next(i for i, (x, y) in enumerate(zip(a.shape, ref.shape))
                    if x != y)
        out[p] = torch.cat([a, b], dim=axis)
    return out


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_tp_quantized_trunk_step(tp_train, mode):
    """``quantize_base`` on a tp = 2 shard: every rank's int8 payloads and
    scales are its shard of the whole trunk's (a row-parallel row takes its
    abs-max over the group, so its scale is the whole row's, replicated),
    and a LoRA micro-batch on that trunk matches one process: the loss
    within 1e-5 relative; int8 (fp32 backward) ``grad_norm`` within 1e-5
    relative and the gradients within 1e-5·max|g|; w8a8 both within 2^-8,
    one bf16 step, as ``test_torch_quant_modes.py::
    test_w8a8_trunk_step_matches_jax`` holds the same step against JAX: its
    straight-through backward rounds ``g · sa`` and each product to bf16,
    and a rank's partial products round apart (2.3e-3–3.4e-3·max|g| here,
    ``grad_norm`` 4.6e-4).  The whole trunk's payloads and scales are the
    JAX package's ``quantize_matrix`` of the same weights, bit for bit."""
    import jax.numpy as jnp

    from ospo_tpu.ops import quant as jquant
    from ospo_tpu_torch.parallel import mesh as tmesh

    whole = tp_train["one"][f"{mode}_layers"]
    scale = "s" if mode == "int8" else "sa"
    jlayers = tp_train["jax_lora"]["params"]["language_model"]["layers"]
    for name, w in whole.items():
        jq = jquant.quantize_matrix(jnp.asarray(jlayers[name]))
        np.testing.assert_array_equal(w["q"].numpy(), np.asarray(jq["q"]))
        np.testing.assert_array_equal(w[scale].numpy(), np.asarray(jq["s"]))
    specs = tmesh.janus_param_specs(
        {"language_model": {"layers": whole}})["language_model"]["layers"]
    for name in ("wo", "w_down"):
        assert specs[name][scale] is None
    tol = 1e-5 if mode == "int8" else 2 ** -8
    for rank, out in enumerate(tp_train["tp"]):
        mesh = tmesh.Mesh(data=1, model=2, rank=rank)
        for name, w in out[f"{mode}_layers"].items():
            for k, t in w.items():
                want = tmesh.shard_leaf(whole[name][k], specs[name][k], mesh)
                assert torch.equal(t, want), (rank, name, k)
        loss, norm, grads = out[mode]
        ref_loss, ref_norm, ref_grads = tp_train["one"][mode]
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        np.testing.assert_allclose(norm, ref_norm, rtol=tol)
        assert _rel(grads, ref_grads) <= tol


def test_tp_checkpoints_both_ways(tp_train):
    """A checkpoint written at tp = 2 holds whole tensors: the adapters and
    their moments equal the ranks' shards joined, and read so in
    ``ospo_tpu.train.checkpoint.load_checkpoint`` and in one port process
    (``resume``); a full fine-tune's ``language_model`` too.  A JAX LoRA
    checkpoint resumes at tp = 2 to its adapters and step."""
    from ospo_tpu.train import checkpoint as jckpt
    from ospo_tpu_torch.train import checkpoint as tckpt

    tp, one = tp_train["tp"], tp_train["one"]
    assert tp[1]["lora_ckpt"] is None and tp[1]["full_ckpt"] is None
    for mode in ("lora", "full"):
        path = tp[0][f"{mode}_ckpt"]
        ranks = [out[f"{mode}_local"] for out in tp]
        trained = _joined([r["trained"] for r in ranks],
                          one[f"{mode}_local"]["trained"])
        opt = _joined([r["opt"] for r in ranks], one[f"{mode}_local"]["opt"])
        tree, _, step, opt_flat = tckpt.load_checkpoint(path)
        assert step == 2
        got = {p: torch.as_tensor(np.asarray(t)) for p, t in
               __import__("ospo_tpu_torch.train.optim", fromlist=["leaves"])
               .leaves(tree)}
        assert set(got) == set(trained)
        for p, t in trained.items():
            assert torch.equal(got[p], t), (mode, p)
        for k, t in opt.items():
            assert torch.equal(torch.as_tensor(opt_flat[k]), t), (mode, k)
        if mode == "lora":
            jtree, jcfg, jstep, _ = jckpt.load_checkpoint(path)
            assert jstep == 2 and jcfg.rank == 4
            for p, x in _jax_flat(jtree).items():
                np.testing.assert_array_equal(x, trained[p].numpy())
            np.testing.assert_array_equal(  # the run's adapters, gathered
                trained["q_proj/a"].numpy(), tp[0]["lora_after"]["q_proj/a"])
    for out in tp:
        assert out["resumed_step"] == 3
        for p, x in _jax_flat(tp_train["resume"]).items():
            np.testing.assert_array_equal(out["resumed"][p], x)


def test_tp_checkpoint_resumes_in_one_process(tp_train, tmp_path):
    """The tp = 2 LoRA checkpoint resumed by a one-process port trainer
    gives its adapters and moments the joined shards, bit for bit."""
    import test_torch_train as tt
    from ospo_tpu_torch.config import Config
    from ospo_tpu_torch.train.optim import leaves
    from ospo_tpu_torch.train.trainer import SimPOTrainer

    ranks = [out["lora_local"] for out in tp_train["tp"]]
    one = tp_train["one"]["lora_local"]
    trained = _joined([r["trained"] for r in ranks], one["trained"])
    opt = _joined([r["opt"] for r in ranks], one["opt"])
    trainer = SimPOTrainer(
        Config.from_nested(tt._trainer_config(tmp_path, "flash")),
        tt._port_model(tp_train["jax_lora"]["params"]), tt._port_processor())
    trainer.resume(tp_train["tp"][0]["lora_ckpt"])
    assert trainer.global_step == 2
    for p, t in leaves(trainer.trainable):
        assert torch.equal(t.detach(), trained[p]), p
    state = trainer.opt.state_dict()
    for k, t in opt.items():
        assert torch.equal(torch.as_tensor(state[k]), t), k


def test_step5_main_tensor_parallel_matches_one_process(tmp_path):
    """``python -m ospo_tpu_torch.pipeline.step5`` under
    ``run_multihost_torch.sh`` with ``model.tensor_parallel=2`` (a world of
    two) and with ``data_parallel=2`` as well (a world of four), against
    ``step5.main`` in one process: tiny random init, LoRA rank 4 from the
    seed's adapters, remat and the flash path, 3 steps of a global batch of
    2 (one row a data index at dp 2).  The final adapters agree within the
    data-parallel test's tolerance (atol 1e-5, rtol 1e-4), so do the logged
    loss and ``grad_norm``; rank 0 alone writes the checkpoint and the
    scalars."""
    from test_torch_distributed import _write_step5_data

    from ospo_tpu_torch.config import build_config
    from ospo_tpu_torch.pipeline import step5

    data = _write_step5_data(tmp_path)
    common = ["--cfg_path", os.path.join(REPO, "configs", "step5.yaml"),
              "model.model_path=null", "model.model_preset=tiny", "device=cpu",
              f"dataset.train.data_path={data}",
              f"image_root={tmp_path / 'step3'}",
              "experiment.max_training_steps=3", "experiment.max_epochs=2",
              "experiment.log_steps=1", "experiment.save_steps=null",
              "experiment.attn_impl=flash", "dataset.train.batch_size=2",
              "lora.lora_rank=4", "lora.lora_alpha=8", "lora.lora_dropout=0",
              "optimizer.init_lr=1e-3"]
    runs = {"tp2": (2, ["model.tensor_parallel=2"]),
            "w4": (4, ["model.tensor_parallel=2", "model.data_parallel=2"])}
    procs = {k: _start(n, "ospo_tpu_torch.pipeline.step5", *common, *extra,
                       f"base.save_path={tmp_path / k}")
             for k, (n, extra) in runs.items()}
    try:
        step5.main(build_config(common[1], overrides=common[2:] + [
            f"base.save_path={tmp_path / 'one'}"], use_cli=False))
    finally:
        outs = {k: _wait(p) for k, p in procs.items()}
    ref = np.load(tmp_path / "one" / "ospo" / "step_000003" / "lora.npz")
    ref_log = [json.loads(x) for x in (tmp_path / "one" / "ospo" /
                                       "scalars.jsonl").read_text().split("\n")
               if x]
    for name, (n, _) in runs.items():
        out = outs[name]
        assert out.count("# Saved checkpoint:") == 1, out[-3000:]
        for rank in range(n):
            assert f"# step5 process {rank}/{n}" in out
        got = np.load(tmp_path / name / "ospo" / "step_000003" / "lora.npz")
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert got[k].shape == ref[k].shape, (name, k)
            np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-4,
                                       err_msg=f"{name}: {k}")
        log = [json.loads(x) for x in (tmp_path / name / "ospo" /
                                       "scalars.jsonl").read_text().split("\n")
               if x]
        assert [x["step"] for x in log] == [1, 2, 3]
        for a, b in zip(log, ref_log):
            for k in ("train/loss", "train/grad_norm"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6,
                                           err_msg=f"{name}: {k}")
