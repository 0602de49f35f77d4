"""-Hartmann-6 (Dixon and Szego 1978) on six continuous parameters, each
uniform on [0, 1]: the objective a configuration names by its
``objective`` key.

Frozen copies: ``evaluate`` and ``space`` come from ``chip_smoke.py``
(``neg_hartmann6`` and ``hartmann_space``, phases 3, 4 and 19), the
objective vectorized over rows.

An objective file gives the harness:

* ``NAMES``: the parameters, in the space's order;
* ``DIM``: the width of the encoded rows, which a parameter of several
  columns (a one-hot, a ``Choice``) makes larger than ``len(NAMES)``;
* ``space()``: the parameter space the program's ``StudyBank`` takes;
* ``history(rng, n_studies, length)``: seeded native rows, an array
  (n_studies, length, len(NAMES)) whose rows hold one value per name,
  each as the program's trials carry it (a float, an int, a bool, a
  string, a ``Choice``'s ``{"_choice": branch, ...}`` dict);
* ``evaluate(rows)`` and ``encode(rows)``: of native rows (..., len(NAMES)),
  the objective (...) and the encoded rows (..., DIM) as float32, written
  from the encoding the port documents and not taken from its code;
* ``candidate_cdf(C)`` and ``candidate_cdf_left(C)``: each encoded
  column's F(x) and its left limit F(x-) under the distribution the space
  draws candidates from, so the check can hold a candidate block to it.

Here every parameter is one column and its own encoding.
"""
from typing import Dict

import numpy as np

_A = np.array([[10, 3, 17, 3.5, 1.7, 8], [0.05, 10, 17, 0.1, 8, 14],
               [3, 3.5, 1.7, 10, 17, 8], [17, 8, 0.05, 10, 0.1, 14]])
_P = 1e-4 * np.array([[1312, 1696, 5569, 124, 8283, 5886],
                      [2329, 4135, 8307, 3736, 1004, 9991],
                      [2348, 1451, 3522, 2883, 3047, 6650],
                      [4047, 8828, 8732, 5743, 1091, 381]])
_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
DIM = 6
NAMES = tuple(f"x{i}" for i in range(DIM))


def evaluate(X: np.ndarray) -> np.ndarray:
    """-Hartmann-6 on [0, 1]^6 (maximum 3.32237) of rows X (..., 6)."""
    X = np.asarray(X, np.float64)
    inner = np.sum(_A * (X[..., None, :] - _P) ** 2, axis=-1)
    return np.sum(_ALPHA * np.exp(-inner), axis=-1)


def space() -> Dict[str, object]:
    from scipy.stats import uniform
    return {name: uniform(0, 1) for name in NAMES}


def history(rng, n_studies: int, length: int) -> np.ndarray:
    """Seeded rows (n_studies, length, DIM), uniform on [0, 1]."""
    return rng.uniform(size=(n_studies, length, DIM))


def encode(rows: np.ndarray) -> np.ndarray:
    """Uniform parameters on [0, 1] are their own encoding."""
    return np.asarray(rows, np.float32)


def candidate_cdf(C):
    """Encoded candidates are uniform on [0, 1): the CDF is the value."""
    return C.clamp(0.0, 1.0)


def candidate_cdf_left(C):
    """The columns have no atoms: F(x-) is F(x)."""
    return candidate_cdf(C)
