"""The route of the weight-only int8 product (``ops/quant.py``), on the CPU.

A T == 1 product on the card runs the kernel ``csrc/w8a16_matmul.cu``
(``tests/test_torch_cuda.py`` holds it against the plain version there).
Everything else keeps its form: a CPU tensor takes the plain ``_w8a16``, a
T > 1 product too, and a product whose input needs a gradient the autograd
Function ``_W8A16``; none of them moves a kernel's launch count.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ospo_tpu_torch.models import llama
from ospo_tpu_torch.ops import quant
from ospo_tpu_torch.utils.profiling import kernel_launches


def _inputs(b, t, d, f, seed=0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((b, t, d), np.float32)).to(dtype)
    qw = quant.quantize_matrix(torch.as_tensor(
        rng.standard_normal((f, d), np.float32) * 0.02).to(dtype))
    return x, qw


@pytest.mark.parametrize("b,t", [(1, 1), (5, 1), (48, 1), (64, 1), (3, 7)])
def test_cpu_product_takes_the_plain_form(b, t):
    """On the CPU, T == 1 or not, ``quantized_matmul`` is ``_w8a16`` bit for
    bit, and no kernel's launch count moves."""
    x, qw = _inputs(b, t, 64, 48, seed=b + t)
    n0 = kernel_launches()
    got = quant.quantized_matmul(x, qw)
    assert torch.equal(got, quant._w8a16(x, qw["q"], qw["s"]))
    assert not quant.w8a16_kernel_takes(x, [qw])
    assert kernel_launches() == n0


def _card_like(shape, dtype=torch.bfloat16, requires_grad=False, device="cuda",
               address=0):
    """A stand-in with the attributes the route reads: a card tensor is not
    at hand on the CPU."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype, shape=shape,
                           requires_grad=requires_grad, dim=lambda: len(shape),
                           is_contiguous=lambda: True, data_ptr=lambda: address)


@pytest.mark.parametrize("x_kw,takes", [
    ({"shape": (48, 1, 4096)}, True),
    ({"shape": (64, 1, 2048)}, True),
    ({"shape": (1, 1, 2048)}, True),
    ({"shape": (48, 2, 4096)}, False),                      # T > 1: the prefill
    ({"shape": (48, 4096)}, False),                         # no position axis
    ({"shape": (48, 1, 4096), "dtype": torch.float32}, False),
    ({"shape": (48, 1, 4104)}, False),                      # D no multiple of 16
    ({"shape": (48, 1, 4096), "device": "cpu"}, False),
    ({"shape": (48, 1, 4096), "requires_grad": True}, False),
    ({"shape": (48, 1, 4096), "address": 8}, False),         # x not 16-byte aligned
])
def test_the_route_follows_from_the_input(x_kw, takes):
    """bf16 x ``[B, 1, D]`` on the card with no gradient wanted takes the
    kernel; a longer T, another dtype or device, a ragged D, an unaligned x
    or an input that needs a gradient keeps its form."""
    x = _card_like(**x_kw)
    d = x.shape[-1]
    qw = {"q": _card_like((4096, d), torch.int8), "s": None}
    assert quant.w8a16_kernel_takes(x, [qw]) is takes


def test_an_input_without_a_gradient_under_no_grad_takes_the_kernel():
    """``requires_grad`` alone does not keep the kernel away: under
    ``torch.no_grad`` no gradient is wanted."""
    x = _card_like((48, 1, 4096), requires_grad=True)
    qw = {"q": _card_like((4096, 4096), torch.int8), "s": None}
    with torch.no_grad():
        assert quant.w8a16_kernel_takes(x, [qw])


def test_a_weight_on_another_device_keeps_its_form():
    x = _card_like((48, 1, 4096))
    qw = {"q": _card_like((4096, 4096), torch.int8, device="cuda:1"), "s": None}
    assert not quant.w8a16_kernel_takes(x, [qw])


def test_a_product_needing_a_gradient_runs_the_autograd_function(monkeypatch):
    """Where x needs a gradient ``quantized_matmul`` runs ``_W8A16`` even if
    the kernel's route would take the shape: the kernel has no backward."""
    monkeypatch.setattr(quant, "w8a16_matmul", _trap)
    x, qw = _inputs(4, 1, 64, 32, seed=3, dtype=torch.float32)
    x.requires_grad_(True)
    y = quant.quantized_matmul(x, qw)
    assert type(y.grad_fn).__name__ == "_W8A16Backward"
    assert torch.equal(y.detach(), quant._w8a16(x.detach(), qw["q"], qw["s"]))


def _trap(*args, **kwargs):
    raise AssertionError("the kernel's route was taken")


def test_quantized_matmuls_share_launches_of_at_most_three(monkeypatch):
    """On the kernel's route the matrices sharing x go in launches of up to
    three, in order; off it each takes ``quantized_matmul``."""
    calls = []

    def fake(x, qws):
        calls.append(len(qws))
        return [quant._w8a16(x, w["q"], w["s"]) for w in qws]

    x, _ = _inputs(6, 1, 64, 8, seed=4)
    qws = [_inputs(1, 1, 64, f, seed=10 + f)[1] for f in (16, 32, 48, 64, 80)]
    want = [quant._w8a16(x, w["q"], w["s"]) for w in qws]
    assert all(torch.equal(a, b) for a, b in zip(quant.quantized_matmuls(x, qws), want))
    assert calls == []
    monkeypatch.setattr(quant, "w8a16_matmul", fake)
    monkeypatch.setattr(quant, "w8a16_kernel_takes", lambda x, qws: True)
    got = quant.quantized_matmuls(x, qws)
    assert calls == [3, 2]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("mode", ["int8", "w8a8", "w8a8-override", "int4", "bf16"])
def test_linears_equal_linear_of_each_weight(mode):
    """``llama.linears`` (the cached step's q/k/v and gate/up) gives what
    ``linear`` gives for each weight, on the CPU for every weight form, and
    launches no kernel there."""
    x, _ = _inputs(6, 1, 64, 8, seed=5)
    rng = np.random.default_rng(6)
    ws = [torch.as_tensor(rng.standard_normal((f, 64), np.float32) * 0.02
                          ).to(torch.bfloat16) for f in (32, 16, 16)]
    if mode != "bf16":
        ws = [quant.quant_fn(mode.split("-")[0])(w) for w in ws]
    n0 = kernel_launches()
    if mode == "w8a8-override":
        with quant.w8a16_override():
            got, want = llama.linears(x, ws), [llama.linear(x, w) for w in ws]
    else:
        got, want = llama.linears(x, ws), [llama.linear(x, w) for w in ws]
    assert len(got) == 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernel_launches() == n0


@pytest.mark.parametrize("mode,override,int8", [
    ("int8", False, True), ("w8a8", False, False), ("w8a8", True, True),
    ("int4", False, False), ("int4g", False, False), ("bf16", False, False)])
def test_weight_only_int8_names_what_the_product_reads(mode, override, int8):
    """An int8 matrix is read as it is; a w8a8 payload with its row scales
    only under ``w8a16_override``; int4 forms and plain weights not at all."""
    w = torch.ones((16, 64), dtype=torch.bfloat16)
    if mode != "bf16":
        w = quant.quant_fn(mode)(w)
    with quant.w8a16_override() if override else torch.no_grad():
        got = quant.weight_only_int8(w)
    assert (got is not None) is int8
    if int8:
        assert got["q"] is w["q"] and got["s"] is w["s" if mode == "int8" else "sa"]
