"""Examples of the PyTorch/CUDA port: counterparts of ``examples/``, run on
the CUDA card unless ``--device cpu`` is given."""
