"""The plain reference of the G-Shell-on-FlexiCubes cells: frozen copies of
the port's FlexiCubes path (``geometry/flexicubes_tables.py``,
``cube_grid.py``, ``gshell_flexicubes.py`` and the geometry and tick of
``flexi_geometry.py``, here ``geometry.py``) and ``trainer.py``, the train
step.  The render, the shade, the ops and the regularizers are those of
``../recon``, imported and not changed.  Plain indexing only, no hand
kernel; it imports nothing of the port."""
