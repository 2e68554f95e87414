"""Hand-written Hopper kernels of the port.

Each kernel ships as ``<name>.py`` (the launching wrapper, with a launch
counter), ``ref.py`` (its plain PyTorch version) and ``ops.py`` (picks
the kernel for a CUDA tensor, the plain version for a CPU tensor); the
CUDA C++ sources live in ``repro_torch/csrc`` and are built at first use
by :mod:`repro_torch.kernels._build`.
"""
