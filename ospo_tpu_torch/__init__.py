"""ospo_tpu_torch — the PyTorch/CUDA port of ``ospo_tpu`` for one NVIDIA H100.

Mirrors the layout of ``ospo_tpu`` (``models/``, ``ops/``, ``engine/``,
``pipeline/``, ``utils/``) and imports nothing of it: the host-side modules
it needs are its own copies.  Every Pallas kernel on a ported path is a
hand-written CUDA kernel under ``ops/csrc`` with a plain PyTorch version
beside it; CPU tensors take the plain version, CUDA tensors the kernel.

Entry points (``get_model``, ``ImageGenEngine``, ``pipeline.step3``) run on
the GPU unless the caller passes ``device="cpu"``; without a GPU and without
that request they raise.
"""
