"""The harness's own account of a search space: native values drawn from a
seed, their encoded unit-cube columns, and the distribution of each
encoded column under the space's candidate draw.

Written from the encoding the port documents (``core/spaces.py``), not
from its code: a string list one-hot in declaration order; a numeric or
boolean list on the linear scale between its smallest and largest choice;
a ``range`` between its first and last value; ``Int`` linear and
``LogInt`` on the log scale of its bounds; ``uniform`` linear and either
log-uniform on its log scale; a constant no column; a ``Choice`` a
one-hot of its branches, then every branch's child columns in
declaration order, a child of an inactive branch at 0.5.  Each column is
computed in float64 and rounded once to float32, as the port rounds its
candidate blocks, so that the harness's rows of a trial equal the
program's candidate row bit for bit.

Under the draw a column has atoms (one-hot, ordinal, integer and imputed
values) and a continuous part (uniform on [0, 1]).  ``Space.cdf`` and
``Space.cdf_left`` give each column's F(x) and its left limit F(x-), so
that ``reference.candidate_ks`` reads the exact Kolmogorov-Smirnov
distance of a column with atoms.

A kind's ``program()`` is the object the port's ``StudyBank`` takes for it:
the space is the program's input, the one thing here taken from it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

CHOICE_KEY = "_choice"
IMPUTED = 0.5


def _f32(x) -> float:
    """A column value as the program holds it: rounded once to float32."""
    return float(np.float32(x))


class Kind:
    """One parameter: ``dims`` encoded columns, ``draw`` native values,
    ``encode`` them (float64, (n, dims)), and ``columns``: for each column
    its atoms {value: probability} and the weight of its continuous part."""
    dims = 1

    def draw(self, rng, n: int) -> list:
        raise NotImplementedError

    def encode(self, values) -> np.ndarray:
        raise NotImplementedError

    def columns(self) -> List[Tuple[Dict[float, float], float]]:
        return [({}, 1.0)]

    def program(self):
        raise NotImplementedError


class Uniform(Kind):
    """``scipy.stats.uniform(loc, scale)``."""

    def __init__(self, loc: float, scale: float):
        self.loc, self.scale = float(loc), float(scale)

    def draw(self, rng, n):
        return (self.loc + self.scale * rng.uniform(size=n)).tolist()

    def encode(self, values):
        v = np.asarray(values, np.float64)
        return np.clip((v - self.loc) / self.scale, 0.0, 1.0)[:, None]

    def program(self):
        from scipy.stats import uniform
        return uniform(self.loc, self.scale)


class LogUniform(Kind):
    """``scipy.stats.loguniform(a, b)``: encoded on the log scale."""

    def __init__(self, a: float, b: float):
        self.a, self.b = float(a), float(b)

    def draw(self, rng, n):
        la, lb = math.log(self.a), math.log(self.b)
        return np.exp(rng.uniform(la, lb, size=n)).tolist()

    def encode(self, values):
        v = np.asarray(values, np.float64)
        la, lb = np.log(self.a), np.log(self.b)
        return np.clip((np.log(v) - la) / (lb - la), 0.0, 1.0)[:, None]

    def program(self):
        from scipy.stats import loguniform
        return loguniform(self.a, self.b)


class LogUniform10(Kind):
    """Mango's ``loguniform(lo_exp, size_exp)``: ``10 ** uniform(lo_exp,
    lo_exp + size_exp)``, encoded on its exponent."""

    def __init__(self, lo_exp: float, size_exp: float):
        self.lo, self.size = float(lo_exp), float(size_exp)

    def draw(self, rng, n):
        return np.power(10.0, rng.uniform(self.lo, self.lo + self.size,
                                          size=n)).tolist()

    def encode(self, values):
        e = np.log10(np.asarray(values, np.float64))
        return np.clip((e - self.lo) / self.size, 0.0, 1.0)[:, None]

    def program(self):
        from repro_torch.core.spaces import loguniform
        return loguniform(self.lo, self.size)


class Discrete(Kind):
    """A kind with finitely many values, each drawn with equal chance
    unless ``weights`` say otherwise; its columns' atoms are its values'
    encodings."""
    values: list

    def weights(self) -> np.ndarray:
        return np.full(len(self.values), 1.0 / len(self.values))

    def draw(self, rng, n):
        return [self.values[i] for i in
                rng.choice(len(self.values), size=n, p=self.weights())]

    def columns(self):
        enc = self.encode(self.values)
        out = []
        for j in range(self.dims):
            atoms: Dict[float, float] = {}
            for x, p in zip(enc[:, j], self.weights()):
                atoms[_f32(x)] = atoms.get(_f32(x), 0.0) + float(p)
            out.append((atoms, 0.0))
        return out


class Categorical(Discrete):
    """A list of choices: strings one-hot, numbers and booleans ordinal."""

    def __init__(self, choices: Sequence):
        self.values = list(choices)
        self.numeric = all(isinstance(c, (int, float, np.number))
                           for c in self.values)
        self.dims = 1 if self.numeric else len(self.values)

    def encode(self, values):
        if self.numeric:
            arr = np.asarray(self.values, np.float64)
            lo, hi = arr.min(), arr.max()
            v = np.asarray(list(values), np.float64)
            return ((v - lo) / max(hi - lo, 1e-12))[:, None]
        index = {c: i for i, c in enumerate(self.values)}
        out = np.zeros((len(values), self.dims))
        out[np.arange(len(values)),
            [index[v] for v in values]] = 1.0
        return out

    def program(self):
        return list(self.values)


class Range(Discrete):
    """A Python ``range``: encoded between its first and last value."""

    def __init__(self, r: range):
        self.r = r
        self.values = list(r)

    def encode(self, values):
        lo, hi = self.values[0], self.values[-1]
        v = np.asarray(list(values), np.float64)
        return ((v - lo) / max(hi - lo, 1))[:, None]

    def program(self):
        return self.r


class Int(Discrete):
    """The port's ``Int(lo, hi)``: uniform over [lo, hi], linear."""

    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = int(lo), int(hi)
        self.values = list(range(self.lo, self.hi + 1))

    def encode(self, values):
        v = np.asarray(list(values), np.float64)
        return ((v - self.lo) / max(self.hi - self.lo, 1))[:, None]

    def program(self):
        from repro_torch.core.spaces import Int as PortInt
        return PortInt(self.lo, self.hi)


class LogInt(Int):
    """The port's ``LogInt(lo, hi)``: exp(uniform(log lo, log hi)) rounded,
    so the integer j has the chance of the log interval that rounds to it;
    encoded on the log scale of its bounds."""

    def weights(self):
        la, lb = math.log(self.lo), math.log(self.hi)
        j = np.asarray(self.values, np.float64)
        lo = np.log(np.maximum(j - 0.5, self.lo))
        hi = np.log(np.minimum(j + 0.5, self.hi))
        return (hi - lo) / (lb - la)

    def encode(self, values):
        v = np.log(np.maximum(np.asarray(list(values), np.float64), 1.0))
        span = max(np.log(self.hi) - np.log(self.lo), 1e-12)
        return np.clip((v - np.log(self.lo)) / span, 0.0, 1.0)[:, None]

    def program(self):
        from repro_torch.core.spaces import LogInt as PortLogInt
        return PortLogInt(self.lo, self.hi)


class Const(Kind):
    """A constant: held fixed, no column."""
    dims = 0

    def __init__(self, value):
        self.value = value

    def draw(self, rng, n):
        return [self.value] * n

    def encode(self, values):
        return np.zeros((len(values), 0))

    def columns(self):
        return []

    def program(self):
        return self.value


class Choice(Kind):
    """The port's ``Choice({branch: {child: kind}})``: a branch drawn with
    equal chance, values ``{"_choice": branch, **children}``."""

    def __init__(self, branches: Dict[str, Dict[str, Kind]]):
        self.branches = [(b, list(sub.items())) for b, sub in
                         branches.items()]
        self.dims = len(self.branches) + sum(
            k.dims for _, sub in self.branches for _, k in sub)

    def draw(self, rng, n):
        pick = rng.integers(0, len(self.branches), size=n)
        kids = [{c: k.draw(rng, n) for c, k in sub}
                for _, sub in self.branches]
        return [{CHOICE_KEY: self.branches[j][0],
                 **{c: kids[j][c][i] for c, _ in self.branches[j][1]}}
                for i, j in enumerate(pick.tolist())]

    def encode(self, values):
        n = len(values)
        names = [b for b, _ in self.branches]
        active = np.array([names.index(v[CHOICE_KEY]) for v in values],
                          np.int64)
        blocks = [np.zeros((n, len(names)))]
        blocks[0][np.arange(n), active] = 1.0
        for j, (_, sub) in enumerate(self.branches):
            rows = np.nonzero(active == j)[0]
            for c, k in sub:
                if k.dims:
                    block = np.full((n, k.dims), IMPUTED)
                    if len(rows):
                        block[rows] = k.encode([values[r][c] for r in rows])
                    blocks.append(block)
        return np.concatenate(blocks, axis=1)

    def columns(self):
        k = len(self.branches)
        out = [({0.0: 1.0 - 1.0 / k, 1.0: 1.0 / k}, 0.0)] * k
        for _, sub in self.branches:
            for _, kind in sub:
                for atoms, w in kind.columns():
                    mixed = {x: p / k for x, p in atoms.items()}
                    mixed[IMPUTED] = mixed.get(IMPUTED, 0.0) + 1.0 - 1.0 / k
                    out.append((mixed, w / k))
        return out

    def program(self):
        from repro_torch.core.spaces import Choice as PortChoice
        return PortChoice({b: {c: k.program() for c, k in sub}
                           for b, sub in self.branches})


class Space:
    """Named kinds in declaration order: ``names``, ``dim`` (the encoded
    width), native rows drawn from a seed, their encoding, and each
    column's distribution under the candidate draw."""

    def __init__(self, kinds: Dict[str, Kind]):
        self.kinds = dict(kinds)
        self.names = tuple(self.kinds)
        self.dim = sum(k.dims for k in self.kinds.values())
        self._cols = [c for k in self.kinds.values() for c in k.columns()]

    def columns_of(self, name: str) -> slice:
        """The encoded columns of one parameter."""
        start = 0
        for n, k in self.kinds.items():
            if n == name:
                return slice(start, start + k.dims)
            start += k.dims
        raise KeyError(name)

    def program(self) -> dict:
        """The space as the port's ``StudyBank`` takes it."""
        return {n: k.program() for n, k in self.kinds.items()}

    def draw(self, rng, shape) -> np.ndarray:
        """Native rows of ``shape`` + (len(names),), an object array of
        Python values, drawn parameter by parameter from ``rng``."""
        n = int(np.prod(shape))
        out = np.empty((n, len(self.names)), object)
        for i, k in enumerate(self.kinds.values()):
            out[:, i] = k.draw(rng, n)
        return out.reshape(*shape, len(self.names))

    def encode64(self, rows) -> np.ndarray:
        """Native rows (..., len(names)) to encoded rows (..., dim) in
        float64."""
        R = np.asarray(rows, dtype=object)
        flat = R.reshape(-1, R.shape[-1])
        blocks = [k.encode(list(flat[:, i]))
                  for i, k in enumerate(self.kinds.values()) if k.dims]
        E = (np.concatenate(blocks, axis=1) if blocks
             else np.zeros((len(flat), 0)))
        return E.reshape(*R.shape[:-1], self.dim)

    def encode(self, rows) -> np.ndarray:
        """Encoded rows (..., dim) as the program holds them, float32."""
        return self.encode64(rows).astype(np.float32)

    def _cdf(self, C: torch.Tensor, right: bool) -> torch.Tensor:
        out = torch.empty_like(C)
        for j, (atoms, w) in enumerate(self._cols):
            x = C[..., j]
            F = w * torch.clamp(x, 0.0, 1.0)
            if atoms:
                at = sorted(atoms)
                pos = torch.tensor(at, dtype=C.dtype, device=C.device)
                cum = torch.tensor([0.0] + list(np.cumsum(
                    [atoms[a] for a in at])), dtype=C.dtype, device=C.device)
                F = F + cum[torch.searchsorted(pos, x.contiguous(),
                                               right=right)]
            out[..., j] = F
        return out

    def cdf(self, C: torch.Tensor) -> torch.Tensor:
        """Each encoded column's F(x) under the candidate draw."""
        return self._cdf(C, right=True)

    def cdf_left(self, C: torch.Tensor) -> torch.Tensor:
        """Each encoded column's left limit F(x-) under the candidate draw."""
        return self._cdf(C, right=False)
