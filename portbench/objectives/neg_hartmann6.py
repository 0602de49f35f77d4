"""-Hartmann-6 (Dixon and Szego 1978) on six continuous parameters, each
uniform on [0, 1]: the objective a configuration names by its
``objective`` key.

Frozen copies: ``evaluate`` and ``space`` come from ``chip_smoke.py``
(``neg_hartmann6`` and ``hartmann_space``, phases 3, 4 and 19), the
objective vectorized over rows.

An objective file gives the harness ``NAMES`` (the parameters, in the
order of the encoded columns), ``DIM``, ``space()`` (the parameter space
the program's ``StudyBank`` takes), ``evaluate(rows)``, ``encode(rows)``
(parameter values to the program's encoded unit-cube rows, float32) and
``candidate_cdf(C)`` (each encoded column's value under the distribution
the space draws candidates from, so the check can hold a candidate block
to that distribution).
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


def encode(rows: np.ndarray) -> np.ndarray:
    """Uniform parameters on [0, 1] are their own encoding."""
    return np.asarray(rows, np.float32)


def candidate_cdf(C):
    """Encoded candidates are uniform on [0, 1): the CDF is the value."""
    return C.clamp(0.0, 1.0)
