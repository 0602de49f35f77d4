"""Chunkwise stabilized mLSTM (xLSTM matrix memory): the mlstm_chunk suite
(``ref.py`` plain versions, ``csrc/`` CUDA C++ forward and backward,
``ops.py`` dispatch and autograd)."""
