"""gshell_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of gshell_tpu.

Mirrors ``gshell_tpu``'s subpackages (``geometry``, ``ops``, ``render``,
``train``, ``utils``); ``gshell_tpu`` stays the reference the port is held
against.  The port imports ``torch`` and never ``jax``; from ``gshell_tpu`` it
reads only the numpy-only modules (tet tables, tet grid).  The two Pallas
kernels of the reference are hand-written CUDA here (``csrc/``), built at
first use by :mod:`gshell_tpu_torch.utils.kernels`.
"""
