"""The plain references of the benchmark's cells.

Frozen copies of the port's plain PyTorch paths at the commit the
benchmark was written against, so that a change to the program cannot
move what it is compared with.  They import nothing of the port.

* ``recon/``: the modules a marching-tets reconstruction step runs
  (``geometry/``, ``ops/``, ``render/``, ``parallel/``, ``utils/``), copied
  whole, with three changes: ``ops/rasterize.rasterize_stage_b`` and
  ``ops/denoiser.bilateral_accumulate`` run their plain versions on every
  device (no hand kernel, no build); ``geometry/mlp.py`` records the rows
  of each MLP evaluation (``evaluations``, for the operation count of
  ``recon_step_mfu``), tagging the eikonal one in ``geometry/geometry.py``.
  ``recon/trainer.py`` is the train step and its setup.
* ``diffusion/``: ``models/unet3d.py``, ``sde.py``, ``losses.py`` and
  ``ema.py``, with one change: every convolution and dense layer can round
  its operands to float8 (``unet3d.operands_in_fp8``), the control.
  ``diffusion/trainer.py`` is the one-process update."""
