"""gshell_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of gshell_tpu.

Mirrors ``gshell_tpu``'s subpackages (``data``, ``geometry``, ``ops``,
``render``, ``train``, ``utils``) and its reconstruction entry points
(``python -m gshell_tpu_torch.train_gshell``, ``.eval_reconstruction``,
``.utils.synthetic_gt``); ``gshell_tpu`` stays the reference the port is held
against.  The port imports ``torch`` and nothing of ``jax`` or ``gshell_tpu``:
it keeps its own copies of the numpy-only modules it needs (tet tables, tet
grid, config, the synthetic meshes).  The two Pallas kernels of the
reference are hand-written CUDA here (``csrc/``), built at first use by
:mod:`gshell_tpu_torch.utils.kernels`.
"""
