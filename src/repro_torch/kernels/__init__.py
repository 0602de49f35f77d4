"""Hand-written Hopper kernels, one suite per folder: ``csrc/`` (CUDA C++),
``ref.py`` (the plain PyTorch version) and ``ops.py`` (dispatch)."""
