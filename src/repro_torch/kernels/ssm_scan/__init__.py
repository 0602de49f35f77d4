"""Mamba selective scan: the ssm_scan suite (``ref.py`` plain versions,
``csrc/`` CUDA C++ forward and backward, ``ops.py`` dispatch and
autograd)."""
