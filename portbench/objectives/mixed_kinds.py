"""A test objective over every kind of parameter the port's spaces offer:
a string list (one-hot), a numeric list, a boolean list and a ``range``
(ordinal), ``Int`` and ``LogInt``, ``uniform``, both log-uniforms (scipy's
and Mango's), a constant, and a two-branch ``Choice`` whose children are
a ``uniform``, a numeric list and an ``Int``.

Its value is -Hartmann-6 (``neg_hartmann6``) on six numeric encoded
columns plus a fixed offset for the choice of each categorical (the
optimizer, the augmentation flag, the schedule's branch).  The file gives
what ``neg_hartmann6.py``'s docstring lists; the encoding and the
columns' distributions are ``space_ref``'s.
"""
from pathlib import Path

import numpy as np

from portbench import space_ref as sr

SPACE = sr.Space({
    "optimizer": sr.Categorical(["sgd", "adam", "rmsprop"]),
    "width": sr.Categorical([16, 32, 64, 128]),
    "augment": sr.Categorical([False, True]),
    "depth": sr.Range(range(1, 9)),
    "units": sr.Int(8, 512),
    "batch": sr.LogInt(16, 1024),
    "dropout": sr.Uniform(0.0, 0.5),
    "lr": sr.LogUniform10(-4, 3),
    "weight_decay": sr.LogUniform(1e-5, 1e-2),
    "epochs": sr.Const(200),
    "schedule": sr.Choice({
        "cosine": {"warmup": sr.Uniform(0.0, 1.0)},
        "step": {"decay": sr.Categorical([0.1, 0.5, 0.9]),
                 "every": sr.Int(1, 10)}}),
})
NAMES = SPACE.names
DIM = SPACE.dim
# the encoded columns -Hartmann-6 reads, and each categorical's offsets
_H6_COLUMNS = [SPACE.columns_of(n).start for n in
               ("units", "batch", "dropout", "lr", "weight_decay", "width")]
_OFFSETS = {"optimizer": [0.0, 0.3, 0.1], "augment": [0.2],
            "schedule": [0.15, 0.0]}


def _load_h6():
    from portbench import harness
    return harness.load_module(Path(__file__).with_name("neg_hartmann6.py"))


def space():
    return SPACE.program()


def history(rng, n_studies: int, length: int) -> np.ndarray:
    return SPACE.draw(rng, (n_studies, length))


def encode(rows) -> np.ndarray:
    return SPACE.encode(rows)


def evaluate(rows) -> np.ndarray:
    E = SPACE.encode64(rows)
    out = _load_h6().evaluate(E[..., _H6_COLUMNS])
    for name, off in _OFFSETS.items():
        cols = SPACE.columns_of(name)
        out = out + E[..., cols.start:cols.start + len(off)] @ np.asarray(off)
    return out


candidate_cdf = SPACE.cdf
candidate_cdf_left = SPACE.cdf_left
