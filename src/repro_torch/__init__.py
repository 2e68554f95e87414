"""PyTorch/CUDA port of the FASE reproduction (reference: :mod:`repro`).

Same directory layout and names as the JAX package so every counterpart
is easy to find; imports ``torch`` and numpy only.  The ported slice is
the FASE main path: guest workload -> :mod:`repro_torch.core.runtime` ->
HTP session -> :class:`repro_torch.core.interface.TorchTarget`, with the
fetch-side Sv39 walk + block gather running in a hand-written CUDA
kernel (``csrc/page_walk.cu``) when the target image lives on a GPU.
"""
