"""Hyperparameter search-space abstraction (paper §2.1).

A copy of ``repro.core.spaces``: the port imports nothing of the JAX
package, and its host draws and encodings must stay bit-identical to it.

A space is a plain dict: ``{"C": uniform(0.1, 10), "kernel": ["rbf", "poly"],
"depth": range(1, 10), "lr": loguniform(-4, 3)}`` — values may be:

  * any scipy.stats frozen distribution (all 70+ work: the only contract is
    ``.rvs(size, random_state)``; ``.cdf`` is used for unit-cube encoding
    when available, as in Garrido-Merchan & Hernandez-Lobato's treatment of
    continuous variables),
  * Python ``range`` (uniform integer),
  * list / tuple / np.ndarray (categorical, sampled uniformly),
  * a constant (held fixed).

``ParamSpace`` turns the dict into: native samplers (Monte-Carlo acquisition
candidates are always *valid* configurations — the paper's approach to
discrete/categorical parameters), a unit-cube encoder for the GP, and a
domain-size estimate used by the adaptive-beta heuristic.

Structured extensions (beyond the paper's flat spaces):

  * ``Int(lo, hi)`` / ``LogInt(lo, hi)`` — uniform / log-uniform integer
    dimensions (tile sizes, microbatch counts) that encode on their own
    (log-)scale instead of riding the categorical-list treatment,
  * ``Choice({branch: {child: ...}})`` — a *conditional* subspace: a
    categorical root whose child parameters exist only when their branch
    is active.  Sampled configs carry ``{"_choice": branch, **children}``;
    the encoding is fixed-width and masked — the root one-hot doubles as
    the per-branch mask column and inactive child dims are imputed at 0.5
    (Garrido-Merchan & Hernandez-Lobato's treatment extended to
    hierarchies) — so the GP/TPE/clustering device pipelines, columnar
    bank draws, and v1 checkpoints all work unchanged,
  * ``ParamSpace(space, constraints=[...])`` — predicate callables over
    the config dict; sampling rejection-resamples violating rows, so
    every Monte-Carlo candidate is a *valid* configuration.

Flat spaces (no Choice/Int/LogInt, no constraints) take exactly the
pre-existing code paths: samples, RNG streams, and encodings are
bit-identical to the unextended ``ParamSpace``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

# key carrying the active branch name inside a sampled Choice value
CHOICE_KEY = "_choice"
# encoded value of an inactive conditional dim (center of the unit cube:
# zero-information imputation for the GP; the mask column disambiguates)
IMPUTED = 0.5
# rounds of constraint rejection-resampling before giving up
_MAX_RESAMPLE = 100


class loguniform:
    """Mango's log-uniform: 10**uniform(lo_exp, lo_exp+size_exp).

    Defined by extending the scipy sampling contract (.rvs/.cdf/.ppf), as the
    paper prescribes for new distributions.
    """

    def __init__(self, lo_exp: float, size_exp: float):
        self.lo = float(lo_exp)
        self.size = float(size_exp)

    def rvs(self, size=None, random_state=None):
        if isinstance(random_state, np.random.Generator):
            rng = random_state
        else:
            rng = np.random.default_rng(random_state)
        e = rng.uniform(self.lo, self.lo + self.size, size)
        return np.power(10.0, e)

    def cdf(self, x):
        x = np.asarray(x, dtype=float)
        e = np.log10(np.maximum(x, 1e-300))
        return np.clip((e - self.lo) / max(self.size, 1e-12), 0.0, 1.0)

    def ppf(self, q):
        return np.power(10.0, self.lo + np.asarray(q) * self.size)


class Int:
    """Uniform integer dimension over the inclusive range [lo, hi]."""

    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = int(lo), int(hi)
        if self.hi < self.lo:
            raise ValueError(f"Int: hi ({hi}) < lo ({lo})")


class LogInt(Int):
    """Log-uniform integer over [lo, hi] (lo >= 1): tile sizes, widths."""

    def __init__(self, lo: int, hi: int):
        super().__init__(lo, hi)
        if self.lo < 1:
            raise ValueError(f"LogInt: lo must be >= 1, got {lo}")


class Choice:
    """Conditional subspace: categorical root + per-branch child params.

    ``Choice({"zero1": {}, "zero3": {"remat": ["none", "full"]}})`` samples
    to ``{"_choice": "zero3", "remat": "full"}`` — child params exist only
    when their branch is active.  Child values may be anything a flat space
    accepts (dist / range / list / const / Int / LogInt) but not another
    Choice: one level of conditionality keeps the masked encoding exact.
    """

    def __init__(self, branches: Dict[str, Dict[str, Any]]):
        if not isinstance(branches, dict) or not branches:
            raise ValueError("Choice: branches must be a non-empty dict")
        for bname, sub in branches.items():
            if not isinstance(sub, dict):
                raise ValueError(
                    f"Choice[{bname!r}]: branch must be a dict of params")
            for cname, cv in sub.items():
                if cname == CHOICE_KEY:
                    raise ValueError(
                        f"Choice[{bname!r}]: {CHOICE_KEY!r} is reserved")
                if isinstance(cv, Choice):
                    raise ValueError(
                        f"Choice[{bname!r}][{cname!r}]: nested Choice is "
                        "not supported (flatten into branch names)")
        self.branches = branches


def _is_distribution(v: Any) -> bool:
    return hasattr(v, "rvs")


def _py(x: Any) -> Any:
    """numpy scalar -> Python scalar (keeps configs JSON-serializable)."""
    return x.item() if isinstance(x, np.generic) else x


class _Param:
    kind: str  # "dist" | "range" | "cat" | "const" | "int" | "logint"
    #            | "choice"

    def __init__(self, name: str, v: Any):
        self.name = name
        if isinstance(v, Choice):
            self.kind = "choice"
            self.branches = [(bname, [_Param(cn, cv)
                                      for cn, cv in sub.items()])
                             for bname, sub in v.branches.items()]
            self.n_branches = len(self.branches)
            # fixed-width layout: root one-hot (doubles as the per-branch
            # mask), then every branch's child blocks in declaration order;
            # per-branch column offsets are kept for decode()
            self._child_cols = []
            col = self.n_branches
            for bname, children in self.branches:
                offs = []
                for c in children:
                    offs.append((c, col, col + c.dims))
                    col += c.dims
                self._child_cols.append(offs)
            self.dims = col
        elif isinstance(v, LogInt):
            self.kind = "logint"
            self.lo, self.hi = v.lo, v.hi
            self.dims = 1
        elif isinstance(v, Int):
            self.kind = "int"
            self.lo, self.hi = v.lo, v.hi
            self.dims = 1
        elif _is_distribution(v):
            self.kind = "dist"
            self.dist = v
            self.dims = 1
            self._ecdf_ref = None   # lazy, for sampling-only distributions
            # Frozen scipy uniform gets a closed-form columnar fast path:
            # rvs == rng.uniform(n)*scale + loc and cdf == (x-loc)/scale
            # bitwise (scipy evaluates exactly these expressions), so the
            # bank's 10^4-10^5-candidate draws skip scipy's per-call arg
            # machinery without perturbing the RNG stream or the encoding.
            self._uniform_ls = None
            # loguniform (scipy name "reciprocal") gets the same treatment:
            # it defines no custom _rvs, so scipy draws it as
            # _ppf(rng.uniform(n)) = exp(log a + u*(log b - log a)), and
            # cdf is (log x - log a)/(log b - log a) — both reproduced here
            # expression-for-expression so values AND the RNG stream stay
            # bitwise identical to the scipy path.
            self._loguniform_abls = None
            try:
                dname = getattr(getattr(v, "dist", None), "name", "")
                if dname == "uniform":
                    _, loc, scale = v.dist._parse_args(*v.args, **v.kwds)
                    self._uniform_ls = (float(loc), float(scale))
                elif dname in ("loguniform", "reciprocal"):
                    (a, b), loc, scale = v.dist._parse_args(*v.args,
                                                            **v.kwds)
                    self._loguniform_abls = (float(a), float(b),
                                             float(loc), float(scale))
            except Exception:
                self._uniform_ls = None
                self._loguniform_abls = None
        elif isinstance(v, range):
            self.kind = "range"
            self.choices = np.array(list(v))
            if len(self.choices) == 0:
                raise ValueError(f"{name}: empty range")
            self.dims = 1
        elif isinstance(v, (list, tuple, np.ndarray)):
            self.kind = "cat"
            self.choices = list(v)
            if len(self.choices) == 0:
                raise ValueError(f"{name}: empty categorical list")
            # numeric lists are ordinal (single dim); strings are one-hot
            self.numeric = all(isinstance(c, (int, float, np.number))
                               for c in self.choices)
            self.dims = 1 if self.numeric else len(self.choices)
        else:
            self.kind = "const"
            self.value = v
            self.dims = 0

    # ---- sampling (native distribution; always-valid configs) -------------
    def sample(self, n: int, rng: np.random.Generator) -> List[Any]:
        if self.kind == "dist":
            out = np.asarray(self.dist.rvs(size=n, random_state=rng))
            return list(out)
        if self.kind == "range":
            return list(rng.choice(self.choices, size=n))
        if self.kind == "cat":
            idx = rng.integers(0, len(self.choices), size=n)
            return [self.choices[i] for i in idx]
        if self.kind in ("int", "logint", "choice"):
            return self._sample_structured(n, rng, as_array=False)
        return [self.value] * n

    def sample_array(self, n: int, rng: np.random.Generator):
        """Columnar ``sample``: same RNG stream, but numeric kinds return the
        ndarray itself instead of a list of Python scalars (the list round
        trip dominates host time at bank scale: B*mc rows per ask)."""
        if self.kind == "dist":
            if self._uniform_ls is not None:
                loc, scale = self._uniform_ls
                return rng.uniform(size=n) * scale + loc
            if self._loguniform_abls is not None:
                a, b, loc, scale = self._loguniform_abls
                u = rng.uniform(size=n)
                return np.exp(np.log(a)
                              + u * (np.log(b) - np.log(a))) * scale + loc
            return np.asarray(self.dist.rvs(size=n, random_state=rng))
        if self.kind == "range":
            return rng.choice(self.choices, size=n)
        if self.kind in ("int", "logint", "choice"):
            return self._sample_structured(n, rng, as_array=True)
        return self.sample(n, rng)   # cat / const stay object lists

    def _sample_structured(self, n: int, rng: np.random.Generator,
                           as_array: bool):
        """One shared draw routine for the structured kinds so the scalar
        (``sample``) and columnar (``sample_array``) paths consume the RNG
        stream identically — the bitwise-parity contract the bank's
        columnar asks rely on extends to conditional spaces for free."""
        if self.kind == "int":
            out = rng.integers(self.lo, self.hi + 1, size=n)
            return out if as_array else [int(v) for v in out]
        if self.kind == "logint":
            u = rng.uniform(size=n)
            e = np.log(self.lo) + u * (np.log(self.hi) - np.log(self.lo))
            out = np.clip(np.rint(np.exp(e)), self.lo,
                          self.hi).astype(np.int64)
            return out if as_array else [int(v) for v in out]
        # choice: draw the root, then a FULL n-length column per child of
        # EVERY branch in declaration order (inactive draws discarded).
        # Full-length columns cost extra draws but make the stream a pure
        # function of (space, n) — never of which branches happened to win —
        # which is what keeps scalar/columnar and resume replays bit-equal.
        ridx = rng.integers(0, self.n_branches, size=n)
        cols = [{c.name: c.sample_array(n, rng) for c in children}
                for _, children in self.branches]
        out = []
        for i in range(n):
            j = int(ridx[i])
            bname, children = self.branches[j]
            val = {CHOICE_KEY: bname}
            for c in children:
                val[c.name] = _py(cols[j][c.name][i])
            out.append(val)
        return out

    def _ecdf(self) -> np.ndarray:
        """Persistent empirical CDF for sampling-only distributions.

        Fitted once from a dedicated fixed-seed draw (not the tuner's RNG
        stream), so the same value encodes identically in every batch and
        across checkpoint/resume — a per-batch min-max fallback would map
        the same config to different GP inputs depending on its batchmates,
        corrupting the surrogate.
        """
        if self._ecdf_ref is None:
            draw = np.asarray(self.dist.rvs(
                size=2048, random_state=np.random.default_rng(0xEC0F)),
                dtype=float)
            self._ecdf_ref = np.sort(draw.reshape(-1))
        return self._ecdf_ref

    # ---- unit-cube encoding ------------------------------------------------
    def encode(self, values: Sequence[Any]) -> np.ndarray:
        n = len(values)
        if self.kind == "dist":
            v = np.asarray(values, dtype=float)
            if self._uniform_ls is not None:
                loc, scale = self._uniform_ls
                enc = np.nan_to_num(np.clip((v - loc) / scale, 0.0, 1.0),
                                    nan=0.5)
                return enc.reshape(n, 1)
            if self._loguniform_abls is not None:
                a, b, loc, scale = self._loguniform_abls
                with np.errstate(all="ignore"):
                    q = ((np.log((v - loc) / scale) - np.log(a))
                         / (np.log(b) - np.log(a)))
                    enc = np.nan_to_num(np.clip(q, 0.0, 1.0), nan=0.5)
                return enc.reshape(n, 1)
            if hasattr(self.dist, "cdf"):
                with np.errstate(all="ignore"):
                    enc = np.nan_to_num(
                        np.asarray(self.dist.cdf(v), dtype=float), nan=0.5)
            else:  # sampling-only distribution: persistent empirical CDF
                ref = self._ecdf()
                enc = np.interp(v, ref, np.linspace(0.0, 1.0, len(ref)))
            return enc.reshape(n, 1)
        if self.kind == "range":
            lo, hi = self.choices[0], self.choices[-1]
            v = np.asarray(values, dtype=float)
            return ((v - lo) / max(hi - lo, 1)).reshape(n, 1)
        if self.kind == "cat":
            if self.numeric:
                arr = np.asarray(self.choices, dtype=float)
                lo, hi = arr.min(), arr.max()
                v = np.asarray(values, dtype=float)
                return ((v - lo) / max(hi - lo, 1e-12)).reshape(n, 1)
            onehot = np.zeros((n, len(self.choices)))
            index = {c: i for i, c in enumerate(self.choices)}
            for r, val in enumerate(values):
                onehot[r, index[val]] = 1.0
            return onehot
        if self.kind == "int":
            v = np.asarray(values, dtype=float)
            return ((v - self.lo) / max(self.hi - self.lo, 1)).reshape(n, 1)
        if self.kind == "logint":
            v = np.log(np.maximum(np.asarray(values, dtype=float), 1.0))
            span = max(np.log(self.hi) - np.log(self.lo), 1e-12)
            return np.clip((v - np.log(self.lo)) / span,
                           0.0, 1.0).reshape(n, 1)
        if self.kind == "choice":
            # root one-hot (the active column IS the branch mask) + every
            # branch's child blocks, inactive rows imputed at IMPUTED
            bindex = {bname: j for j, (bname, _) in enumerate(self.branches)}
            ridx = np.array([bindex[v[CHOICE_KEY]] for v in values],
                            dtype=np.int64)
            onehot = np.zeros((n, self.n_branches))
            if n:
                onehot[np.arange(n), ridx] = 1.0
            blocks = [onehot]
            for j, (_, children) in enumerate(self.branches):
                rows = np.nonzero(ridx == j)[0]
                for c in children:
                    if c.dims == 0:
                        continue
                    block = np.full((n, c.dims), IMPUTED)
                    if len(rows):
                        block[rows] = c.encode(
                            [values[r][c.name] for r in rows])
                    blocks.append(block)
            return np.concatenate(blocks, axis=1)
        return np.zeros((n, 0))

    # ---- inverse encoding (unit cube -> native values) ---------------------
    def decode(self, X: np.ndarray) -> List[Any]:
        """Inverse of ``encode`` up to quantization: continuous dims invert
        the CDF, discrete dims snap to the nearest choice, one-hot blocks
        argmax.  ``decode(encode(vals)) == vals`` for every discrete kind;
        continuous kinds round-trip to float precision."""
        X = np.asarray(X, dtype=float)
        n = X.shape[0]
        if self.kind == "const":
            return [self.value] * n
        if self.kind == "dist":
            q = np.clip(X[:, 0], 0.0, 1.0)
            if self._uniform_ls is not None:
                loc, scale = self._uniform_ls
                return list(loc + q * scale)
            if self._loguniform_abls is not None:
                a, b, loc, scale = self._loguniform_abls
                return list(np.exp(np.log(a)
                                   + q * (np.log(b) - np.log(a)))
                            * scale + loc)
            if hasattr(self.dist, "ppf"):
                return list(np.asarray(self.dist.ppf(q), dtype=float))
            ref = self._ecdf()
            return list(np.interp(q, np.linspace(0.0, 1.0, len(ref)), ref))
        if self.kind == "int":
            v = self.lo + X[:, 0] * max(self.hi - self.lo, 1)
            return [int(x) for x in
                    np.clip(np.rint(v), self.lo, self.hi)]
        if self.kind == "logint":
            e = (np.log(self.lo)
                 + X[:, 0] * max(np.log(self.hi) - np.log(self.lo), 1e-12))
            return [int(x) for x in
                    np.clip(np.rint(np.exp(e)), self.lo, self.hi)]
        if self.kind == "range":
            arr = np.asarray(self.choices, dtype=float)
            lo, hi = self.choices[0], self.choices[-1]
            v = lo + X[:, 0] * max(hi - lo, 1)
            idx = np.abs(arr[None, :] - v[:, None]).argmin(axis=1)
            return [_py(self.choices[i]) for i in idx]
        if self.kind == "cat":
            if self.numeric:
                arr = np.asarray(self.choices, dtype=float)
                lo, hi = arr.min(), arr.max()
                v = lo + X[:, 0] * max(hi - lo, 1e-12)
                idx = np.abs(arr[None, :] - v[:, None]).argmin(axis=1)
            else:
                idx = X.argmax(axis=1)
            return [self.choices[i] for i in idx]
        # choice: argmax the root one-hot, then decode only the winning
        # branch's child block for each row
        ridx = X[:, :self.n_branches].argmax(axis=1)
        out: List[Any] = []
        for i in range(n):
            j = int(ridx[i])
            bname, _ = self.branches[j]
            val = {CHOICE_KEY: bname}
            for c, lo_col, hi_col in self._child_cols[j]:
                if c.dims == 0:
                    val[c.name] = c.value
                else:
                    val[c.name] = _py(
                        c.decode(X[i:i + 1, lo_col:hi_col])[0])
            out.append(val)
        return out

    @property
    def cardinality(self) -> float:
        if self.kind == "dist":
            return 100.0  # continuous: effective resolution heuristic
        if self.kind in ("range", "cat"):
            return float(len(self.choices))
        if self.kind in ("int", "logint"):
            return float(self.hi - self.lo + 1)
        if self.kind == "choice":
            total = 0.0
            for _, children in self.branches:
                prod = 1.0
                for c in children:
                    prod *= c.cardinality
                total += prod
            return total
        return 1.0


class ParamSpace:
    def __init__(self, space: Dict[str, Any],
                 constraints: Optional[
                     Sequence[Callable[[Dict], bool]]] = None):
        if not isinstance(space, dict) or not space:
            raise ValueError("param space must be a non-empty dict")
        self.params = [_Param(k, v) for k, v in space.items()]
        self.names = [p.name for p in self.params]
        self.dim = sum(p.dims for p in self.params)
        self.constraints = list(constraints) if constraints else []
        for f in self.constraints:
            if not callable(f):
                raise ValueError("constraints must be callables cfg -> bool")
        self.is_conditional = any(p.kind == "choice" for p in self.params)

    def feasible(self, cfg: Dict) -> bool:
        return all(f(cfg) for f in self.constraints)

    def sample(self, n: int, rng: np.random.Generator) -> List[Dict]:
        rows = self._sample_rows(n, rng)
        if not self.constraints:
            return rows
        # rejection resampling: every returned row satisfies every
        # constraint, so Monte-Carlo candidates stay *valid* configurations
        ok = [r for r in rows if self.feasible(r)]
        for _ in range(_MAX_RESAMPLE):
            if len(ok) >= n:
                break
            ok.extend(r for r in self._sample_rows(n, rng)
                      if self.feasible(r))
        if len(ok) < n:
            raise RuntimeError(
                f"constraints rejected >{_MAX_RESAMPLE}x oversampling; "
                "the feasible region is (near-)empty — relax the "
                "constraints or shrink the space")
        return ok[:n]

    def _sample_rows(self, n: int, rng: np.random.Generator) -> List[Dict]:
        cols = {p.name: p.sample(n, rng) for p in self.params}
        return [{k: cols[k][i] for k in cols} for i in range(n)]

    # ---- columnar sampling (StudyBank's batched-candidate fast path) ----
    # Draws the *same* RNG stream as ``sample(n, rng)`` (one per-param draw
    # each, in declaration order) but skips materializing n row dicts, so a
    # bank ask can sample B*n_mc candidates and encode them in one pass;
    # only the few winning rows ever become config dicts (``config_at``).
    def sample_columns(self, n: int,
                       rng: np.random.Generator) -> Dict[str, Any]:
        if self.constraints:
            # constrained spaces route through the row sampler so columnar
            # and scalar draws stay trivially the same stream (rejection
            # makes the draw count data-dependent; no columnar shortcut)
            rows = self.sample(n, rng)
            return {p.name: [r[p.name] for r in rows] for p in self.params}
        return {p.name: p.sample_array(n, rng) for p in self.params}

    def encode_columns(self, cols: Dict[str, List[Any]],
                       n: int) -> np.ndarray:
        blocks = [p.encode(cols[p.name]) for p in self.params if p.dims]
        return (np.concatenate(blocks, axis=1) if blocks
                else np.zeros((n, 0)))

    def config_at(self, cols: Dict[str, Any], i: int) -> Dict:
        # .item() unwraps ndarray columns to Python scalars so trial params
        # stay JSON-serializable (state_dict carries them verbatim)
        return {p.name: (cols[p.name][i].item()
                         if isinstance(cols[p.name], np.ndarray)
                         else cols[p.name][i])
                for p in self.params}

    def configs_at(self, cols: Dict[str, Any], idx) -> List[Dict]:
        """Batched ``config_at``: one fancy-index + ``tolist`` per column
        instead of a per-row dictcomp with per-scalar ``.item()`` calls
        (the bank materializes B*n winner configs per ask)."""
        idx = np.asarray(idx, dtype=np.int64)
        names = [p.name for p in self.params]
        pulled = []
        for p in self.params:
            c = cols[p.name]
            if isinstance(c, np.ndarray):
                pulled.append(c[idx].tolist())   # tolist -> Python scalars
            else:
                pulled.append([c[i] for i in idx])
        return [dict(zip(names, row)) for row in zip(*pulled)]

    def encode(self, configs: List[Dict]) -> np.ndarray:
        if not configs:
            return np.zeros((0, self.dim))
        blocks = [p.encode([c[p.name] for c in configs]) for p in self.params
                  if p.dims]
        return np.concatenate(blocks, axis=1) if blocks else np.zeros(
            (len(configs), 0))

    def decode(self, X: np.ndarray) -> List[Dict]:
        """Inverse of ``encode``: unit-cube rows back to config dicts
        (discrete dims snap to the nearest valid choice; conditional
        params argmax their mask columns and decode only the active
        branch).  Useful for interpreting GP argmax points and for
        round-trip testing the masked encoding."""
        X = np.asarray(X, dtype=float)
        out: List[Dict] = [dict() for _ in range(X.shape[0])]
        col = 0
        for p in self.params:
            vals = p.decode(X[:, col:col + p.dims])
            col += p.dims
            for i, v in enumerate(vals):
                out[i][p.name] = v
        return out

    @property
    def domain_size(self) -> float:
        s = 1.0
        for p in self.params:
            s *= p.cardinality
        return min(s, 1e12)

    def mc_samples(self, batch_size: int = 1) -> int:
        """Paper §2.3: sample count scales with #params / space complexity."""
        base = 1000 * max(self.dim, 1) + 200 * int(math.log10(
            self.domain_size + 1))
        return int(np.clip(base * max(1, batch_size // 2), 2000, 32768))
