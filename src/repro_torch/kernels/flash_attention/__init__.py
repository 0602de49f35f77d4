"""Causal / non-causal GQA attention with an online softmax: the flash
attention suite (``ref.py`` plain version, ``csrc/`` CUDA C++, ``ops.py``
dispatch)."""
