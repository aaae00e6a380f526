"""The port's weights gate (``ospo_tpu_torch/validate_weights.py``) on a
tiny synthetic checkpoint: the four cases of ``tests/test_validate_weights.py``
run on the port, and the cross-package oracle — each package's
``--compare-reference`` scores itself against the other's
``--export-reference`` of the same directory, both ways."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from ospo_tpu_torch import validate_weights as tvw
from ospo_tpu_torch.models import janus as tjanus
from ospo_tpu_torch.models import synthetic

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(REPO, "scripts"))

# the bounds tests/test_torch_scoring.py holds the port's p_yes / p_no to
# against ospo_tpu: within P_ABS and within P_REL of the value
P_ABS, P_REL = 2e-4, 1e-3

torch.set_num_threads(2)
# the first parallel CPU exp of a process can be off (ROADMAP §3): warm up
torch.exp(torch.zeros(64))
torch.exp(torch.zeros(1 << 17))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return synthetic.write_synthetic_checkpoint(
        str(tmp_path_factory.mktemp("vw") / "ckpt"),
        tjanus.tiny_janus_config(), seed=0)


def _port(*args):
    return tvw.main(list(args) + ["--device", "cpu"])


def _jax(*args):
    import validate_weights as jvw

    return jvw.main(list(args))


def test_validate_weights_on_synthetic_checkpoint(ckpt, tmp_path):
    report = _port("--model_path", ckpt, "--out", str(tmp_path / "val"),
                   "--tokens", "32", "--batch", "2", "--quantize", "int8")
    assert report["port"]["ok"]
    assert report["modules"]["ok"]
    assert set(report["modules"]) == {"vit_embeds", "vq_roundtrip", "trunk",
                                      "ok"}
    div = report["divergence"]
    for key in ("kv_int8_vs_bf16", "kv_int4_vs_bf16"):
        assert 0.0 <= div[key]["top1_agree"] <= 1.0
        assert div[key]["kl_mean"] >= 0.0
        assert len(div[key]["by_quarter"]) == 4
    assert report["samples"]["ok"]
    assert len(report["samples"]["samples"]) == 3

    on_disk = json.load(open(tmp_path / "val" / "validation_report.json"))
    assert on_disk["model_path"] == ckpt
    for i in range(3):
        assert os.path.exists(tmp_path / "val" / f"sample_{i}.png")


def test_weight_divergence_mode(ckpt, tmp_path):
    report = _port("--model_path", ckpt, "--out", str(tmp_path / "val"),
                   "--phases", "divergence", "--tokens", "16", "--batch", "2",
                   "--quantize", "none", "--weight-divergence")
    for key in ("w_int8_vs_bf16", "w_w8a8_vs_bf16", "w_int4_vs_bf16",
                "w_int4g_vs_bf16"):
        w = report["divergence"][key]
        assert w["kl_mean"] >= 0.0 and 0.0 <= w["top1_agree"] <= 1.0


def test_two_process_weight_gate(ckpt, tmp_path):
    """Export from a bf16 load, then compare a fresh bf16 load (exact) and
    an int4 one (finite divergence)."""
    ref = str(tmp_path / "ref")
    common = ["--model_path", ckpt, "--phases", "divergence",
              "--tokens", "16", "--batch", "2"]
    rep = _port(*common, "--out", str(tmp_path / "v0"), "--quantize", "none",
                "--export-reference", ref)
    assert rep["divergence"]["exported"] == ref
    assert os.path.exists(os.path.join(ref, "forced.npy"))

    rep = _port(*common, "--out", str(tmp_path / "v1"), "--quantize", "none",
                "--compare-reference", ref)
    w = rep["divergence"]["w_none_vs_none"]
    assert w["kl_mean"] < 1e-4 and w["top1_agree"] == 1.0

    rep = _port(*common, "--out", str(tmp_path / "v2"), "--quantize", "int4",
                "--compare-reference", ref)
    w = rep["divergence"]["w_int4_vs_none"]
    assert w["kl_mean"] >= 0.0 and 0.0 <= w["top1_agree"] <= 1.0
    assert len(w["by_quarter"]) == 4
    with pytest.raises(SystemExit, match="shape mismatch"):
        _port(*common[:-1], "3", "--out", str(tmp_path / "v3"),
              "--quantize", "none", "--compare-reference", ref)


def test_two_process_scoring_gate(ckpt, tmp_path, monkeypatch):
    """The bf16 reference never enters the shared-prefix path; a fresh bf16
    load reproduces it exactly; an int8 load reports finite gaps."""
    from ospo_tpu_torch.engine.scoring import ScoringEngine

    ref = str(tmp_path / "ref")
    common = ["--model_path", ckpt, "--phases", "scoring"]

    def boom(self, *a, **k):
        raise AssertionError("the bf16 reference entered the shared path")

    with monkeypatch.context() as m:
        m.setattr(ScoringEngine, "_execute_shared_multi", boom)
        rep = _port(*common, "--out", str(tmp_path / "v0"), "--quantize",
                    "none", "--export-reference", ref)
    assert rep["scoring"]["exported"] == ref
    assert os.path.exists(os.path.join(ref, "scoring_ref.npz"))

    rep = _port(*common, "--out", str(tmp_path / "v1"), "--quantize", "none",
                "--compare-reference", ref)
    m = rep["scoring"]["scoring_bf16_vs_bf16"]
    assert m["max_abs_dp_yes"] < 1e-6
    assert m["answer_agree"] == 1.0 and m["pair_agree"] == 1.0

    rep = _port(*common, "--out", str(tmp_path / "v2"), "--quantize", "int8",
                "--compare-reference", ref)
    m = rep["scoring"]["scoring_int8_vs_bf16"]
    assert m["mean_abs_dp_yes"] >= 0.0 and 0.0 <= m["pair_agree"] <= 1.0


RUNNERS = {"port": _port, "jax": _jax}


@pytest.mark.parametrize("exporter,comparer", [("jax", "port"),
                                               ("port", "jax")])
def test_divergence_reference_crosses_packages(ckpt, tmp_path, exporter,
                                               comparer):
    """One package exports the bf16 reference (forced tokens, logits,
    fingerprint); the other loads the same directory and compares: equal
    fingerprints, KL under 1e-4 and top-1 agreement of at least 0.95."""
    ref = str(tmp_path / "ref")
    common = ["--model_path", ckpt, "--phases", "divergence", "--tokens", "16",
              "--batch", "2", "--quantize", "none"]
    RUNNERS[exporter](*common, "--out", str(tmp_path / "e"),
                      "--export-reference", ref)
    rep = RUNNERS[comparer](*common, "--out", str(tmp_path / "c"),
                            "--compare-reference", ref)
    from ospo_tpu_torch.pipeline.model_factory import get_model

    model, _, _ = get_model({"model_path": ckpt, "device": "cpu"})
    meta = json.load(open(os.path.join(ref, "meta.json")))
    assert meta["weight_fingerprint"] == tvw._weight_fingerprint(model)
    w = rep["divergence"]["w_none_vs_none"]
    assert w["kl_mean"] < 1e-4 and w["top1_agree"] >= 0.95, w


@pytest.mark.parametrize("exporter,comparer", [("jax", "port"),
                                               ("port", "jax")])
def test_scoring_reference_crosses_packages(ckpt, tmp_path, exporter,
                                            comparer):
    """The scoring reference across packages: every pair choice the same,
    each p_yes / p_no within the port's scoring bounds of the other
    package's, and the comparer's report within P_ABS."""
    refs = {}
    for who in ("jax", "port"):
        refs[who] = str(tmp_path / who)
        RUNNERS[who]("--model_path", ckpt, "--phases", "scoring", "--out",
                     str(tmp_path / f"e_{who}"), "--quantize", "none",
                     "--export-reference", refs[who])
    a, b = (np.load(os.path.join(refs[w], "scoring_ref.npz"))
            for w in (comparer, exporter))
    for k in ("p_yes", "p_no"):
        assert np.all(np.abs(a[k] - b[k])
                      <= np.minimum(P_ABS, P_REL * np.abs(b[k]) + 1e-9)), k
    np.testing.assert_array_equal(a["chosen"], b["chosen"])
    np.testing.assert_array_equal(a["fingerprint"], b["fingerprint"])
    rep = RUNNERS[comparer]("--model_path", ckpt, "--phases", "scoring",
                            "--out", str(tmp_path / "c"), "--quantize", "none",
                            "--compare-reference", refs[exporter])
    m = rep["scoring"]["scoring_bf16_vs_bf16"]
    assert m["pair_agree"] == 1.0 and m["max_abs_dp_yes"] <= P_ABS, m
