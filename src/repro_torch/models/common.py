"""Shared model machinery: sharding context, runtime policy, norms, RoPE,
init, logits and the chunked cross-entropy loss.

The counterpart of ``repro.models.common``, as plain functions on tensors.
Sharding is expressed through a ``ShardCtx``, so the same model code runs:
  * un-meshed (``ShardCtx.null()``, the default ``Runtime()``): plain
    tensors, every constraint a no-op;
  * on a ``torch.distributed`` ``DeviceMesh`` with ``DTensor`` state placed
    by ``repro_torch.launch.sharding``: ``constrain`` redistributes an
    activation to the reference's spec at the reference's sites.
Its axis arithmetic (``axis_size``, ``div``, ...) reads only the mesh's
axis names and sizes (a ``MeshSpec``), so the layout rules run with no
process group, as the JAX package's run on abstract trees.  There is no
``use_pallas`` switch: on the card the kernels always run.

Wherever the JAX package multiplies ``compute_dtype`` operands with
``preferred_element_type=float32``, the port multiplies the operands,
rounded to ``compute_dtype``, in ``accum_dtype`` (``accum_product``): a
bf16 product rounded to bf16 and then widened would lose what the
reference keeps.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.checks import is_dtensor


# --------------------------------------------------------------------------- #
# Sharding context
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names and sizes, major to minor: what the layout rules
    read of a mesh (the JAX ``Mesh``'s ``axis_names`` and ``shape``)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def mesh_placements(spec: Sequence[Any], axis_names: Sequence[str]) -> list:
    """One DTensor placement per mesh axis for ``spec`` (one entry per
    tensor dim: an axis name, a tuple of names, or None): ``Shard(i)`` on
    each axis named at dim i, ``Replicate()`` elsewhere.  A dim split over
    several axes names them in mesh order, major first, as DTensor orders
    the shards of one dim (``P(("data", "model"))`` is data-major)."""
    from torch.distributed.tensor import Replicate, Shard
    out: list = [Replicate() for _ in axis_names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [axis_names.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"axes {names} of dim {dim} are not in mesh "
                             f"order {tuple(axis_names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {axis_names[i]!r} named twice "
                                 f"in {tuple(spec)}")
            out[i] = Shard(dim)
    return out


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh-aware axis resolution with divisibility fallbacks.  ``mesh`` is
    the abstract mesh the rules read; ``device_mesh``, when set, is the
    ``DeviceMesh`` of the same shape that ``constrain`` places on."""

    mesh: Optional[MeshSpec] = None
    dp_axes: Tuple[str, ...] = ()     # batch-parallel axes, e.g. ("pod", "data")
    tp_axis: Optional[str] = None     # tensor-parallel axis ("model")
    # parameter-shard axis or tuple of axes ("data" / ("data", "model"))
    fsdp_axis: Optional[object] = None
    seq_parallel: bool = False        # shard activations over seq between blocks
    shard_lstm_r: bool = False        # FSDP-shard sLSTM recurrent weights
    device_mesh: Any = dataclasses.field(default=None, compare=False,
                                         hash=False, repr=False)

    @staticmethod
    def null() -> "ShardCtx":
        return ShardCtx()

    def axis_size(self, axis) -> int:
        if self.mesh is None or axis is None:
            return 1
        if isinstance(axis, (tuple, list)):
            n = 1
            for a in axis:
                n *= self.mesh.shape[a]
            return n
        return self.mesh.shape[axis]

    @property
    def tp(self) -> int:
        return self.axis_size(self.tp_axis)

    @property
    def dp(self) -> int:
        return self.axis_size(self.dp_axes) if self.dp_axes else 1

    @property
    def fsdp(self) -> int:
        return self.axis_size(self.fsdp_axis)

    def div(self, n: int, axis):
        """Return ``axis`` if dimension ``n`` is divisible by its mesh size."""
        if self.mesh is None or axis is None:
            return None
        return axis if n % self.axis_size(axis) == 0 else None

    def placements(self, spec: Sequence[Any]) -> list:
        return mesh_placements(spec, self.mesh.axis_names)

    def partial_over(self, entry) -> list:
        """One placement per mesh axis: ``Partial()`` on the axes ``entry``
        names (the data axes a batch is split over), ``Replicate()``
        elsewhere.  It is the gradient of a weight that enters a
        ``local_map`` region whole while the batch is split: each rank's
        gradient sums its own rows only, so the gradients of the ranks
        along those axes add up to the whole."""
        from torch.distributed.tensor import Partial, Replicate
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        return [Partial() if a in names else Replicate()
                for a in self.mesh.axis_names]

    def constrain(self, x: torch.Tensor, *spec) -> torch.Tensor:
        """Redistribute a ``DTensor`` to ``spec``'s placements (a partial
        sum is reduced); a plain tensor is returned unchanged (the JAX
        version is a no-op without a mesh)."""
        if not is_dtensor(x):
            return x
        want = tuple(self.placements(spec))
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)

    # Convenience specs -----------------------------------------------------
    def batch_spec(self, n_batch: int):
        return self.div(n_batch, self.dp_axes)

    def act(self, x: torch.Tensor, batch_dim_size: int,
            *rest) -> torch.Tensor:
        """Constrain an activation whose dim 0 is the (global) batch."""
        return self.constrain(x, self.div(batch_dim_size, self.dp_axes),
                              *rest)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a local shard's gradient
    goes back into DTensor views, which need its rows dense (the plain
    versions' gradients may come out permuted)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """x, its gradient made contiguous (the local tensors that a
    ``local_map`` region's inputs become)."""
    return _ContiguousGrad.apply(x)


def on_local_shards(fn, sc: "ShardCtx", ins, out_placements, shape=None):
    """``fn`` on this rank's local tensors of ``ins``, (tensor, gradient
    placements) pairs, each DTensor already in the placements that ``fn``
    reads and its local tensor made contiguous (a plain tensor passes
    through): a ``local_map`` region.  Each output becomes a DTensor in its
    entry of ``out_placements`` (a tuple of them for a tuple output).
    ``shape`` is a single output's global shape, which a split into
    unequal shares needs (a sequence over the model axis: DTensor would
    infer it from even shares); the output is then made contiguous."""
    from torch.distributed.tensor import DTensor
    local = [contiguous_grad(t.to_local(grad_placements=g).contiguous())
             if is_dtensor(t) else t for t, g in ins]
    out = fn(*local)
    if shape is not None:
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(out.contiguous(), sc.device_mesh,
                                  out_placements, run_check=False,
                                  shape=shape, stride=stride)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, sc.device_mesh, pl,
                                        run_check=False)
                     for o, pl in zip(out, out_placements))
    return DTensor.from_local(out, sc.device_mesh, out_placements,
                              run_check=False)


def on_batch_shards(fn, sc: "ShardCtx", acts: Sequence[torch.Tensor],
                    weights: Sequence[torch.Tensor] = (),
                    out: Sequence[Any] = (1,)):
    """``fn(*acts, *weights)``; on a mesh (``acts[0]`` a DTensor), on each
    rank's shard of the batch (``on_local_shards``): the activations
    ``acts`` (dim 0 the batch) split over the data axes and whole over the
    others, the ``weights`` whole (their gradient a partial sum over the
    data axes, ``partial_over``).  ``out`` names each output: its number of
    dims (dim 0 the batch), or "sum" for a per-rank sum, partial over the
    data axes.  Returns what ``fn`` returns (as DTensors on a mesh)."""
    if not is_dtensor(acts[0]):
        return fn(*acts, *weights)
    bs = sc.div(acts[0].shape[0], sc.dp_axes)

    def rows(n: int) -> list:
        return sc.placements((bs,) + (None,) * (n - 1))

    acts = [sc.constrain(a, bs, *(None,) * (a.dim() - 1)) for a in acts]
    weights = [sc.constrain(w, *(None,) * w.dim()) for w in weights]
    out_pl = [sc.partial_over(bs) if o == "sum" else rows(o) for o in out]
    return on_local_shards(
        fn, sc, [(a, rows(a.dim())) for a in acts]
        + [(w, sc.partial_over(bs)) for w in weights],
        out_pl[0] if len(out_pl) == 1 else tuple(out_pl))


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Policy threaded through the model functions: parameters are stored in
    ``param_dtype``, activations computed in ``compute_dtype``, and scores
    and logits multiplied and summed in ``accum_dtype``; the rest are the
    training and routing knobs of the reference's ``Runtime`` (the mLSTM
    kernel's chunk is fixed at 64 tokens, as the Pallas kernel's is; the
    Mamba scan has no chunk: its kernel and plain version walk every
    step).  ``sc`` is the sharding context (un-meshed by default);
    ``attn_fallback`` splits attention whose heads do not divide the
    model axis over its keys ("kvseq") or its query rows ("qseq",
    ``models.attention``); ``moe_expert_parallel`` chooses the
    expert-parallel layout of the MoE weights
    (``launch.sharding.expert_parallel_overrides``)."""

    sc: ShardCtx = dataclasses.field(default_factory=ShardCtx.null)
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32
    attn_fallback: str = "kvseq"       # heads%TP!=0: "kvseq" | "qseq" shard
    lstm_bf16_states: bool = False     # stash xLSTM outputs in bf16
    ce_chunk: int = 512                # seq chunk for cross-entropy
    ssm_chunk: int = 256               # chunk of the stateful mLSTM scan
    moe_capacity_factor: float = 0.0   # 0 -> use cfg.capacity_factor
    moe_expert_parallel: bool = False  # shard expert axis over TP (EP mode)
    remat_policy: str = "full"         # none | dots | full
    z_loss: float = 1e-4


# --------------------------------------------------------------------------- #
# Norms / activations
# --------------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Normalise in fp32, cast to x's dtype, then scale (the reference's
    order, which bf16 parity needs)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def norm_apply(kind: str, x: torch.Tensor, p: dict) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def norm_init(kind: str, d: int, dtype, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def act_fn(name: str):
    """silu, or the tanh-approximated gelu that ``jax.nn.gelu`` computes by
    default."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise KeyError(name)


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #
_PHI_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_PHI_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def dense_init(gen: torch.Generator, fan_in: int, shape: Sequence[int],
               dtype) -> torch.Tensor:
    """Normal truncated to +-2 sigma, sigma = fan_in^-1/2, drawn on the
    generator's device by inverting the normal CDF over [Phi(-2), Phi(2)]
    (the numbers differ from ``jax.random``'s; tests carry parameters across
    with ``convert.model_params_from_numpy``)."""
    u = torch.rand(tuple(shape), generator=gen, device=gen.device,
                   dtype=torch.float32)
    p = _PHI_LO + (_PHI_HI - _PHI_LO) * u
    z = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
    return (z.clamp_(-2.0, 2.0) * fan_in ** -0.5).to(dtype)


# --------------------------------------------------------------------------- #
# Positions
# --------------------------------------------------------------------------- #
def rope_tables(positions: torch.Tensor, hd: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (B, S) -> cos/sin tables (B, S, hd//2) in fp32."""
    dev = positions.device
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=dev) / hd))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (B, S, hd//2).  Rotates the pairs
    (x[i], x[i + hd/2]): the first half against the second, as the
    reference's code does (its docstring says interleaved)."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _inv_freq(d: int, device) -> torch.Tensor:
    return 1.0 / (10_000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                            device=device) / d))


def sinusoidal_position_at(pos: int, d: int, device=None) -> torch.Tensor:
    """Single sinusoidal position row -> (d,) fp32."""
    ang = float(pos) * _inv_freq(d, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)])


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    ang = pos * _inv_freq(d, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)  # (S, d)


# --------------------------------------------------------------------------- #
# Logits
# --------------------------------------------------------------------------- #
def accum_product(a: torch.Tensor, b: torch.Tensor,
                  rt: Runtime) -> torch.Tensor:
    """a @ b of the operands rounded to the compute dtype, multiplied and
    summed in the accumulation dtype (the reference's
    ``preferred_element_type=float32``)."""
    ad, cd = rt.accum_dtype, rt.compute_dtype
    return torch.matmul(a.to(cd).to(ad), b.to(cd).to(ad))


def logits_for(x: torch.Tensor, w_head: torch.Tensor, rt: Runtime,
               vocab_size: int) -> torch.Tensor:
    """(B, S, Vp) logits in the accumulation dtype of x (B, S, d); padded
    vocabulary columns are -1e30, so they never win an argmax."""
    Vp = w_head.shape[1]
    logits = accum_product(x, w_head, rt)
    if Vp != vocab_size:
        col = torch.arange(Vp, device=logits.device)
        logits = torch.where(col < vocab_size, logits, -1e30)
    return logits


# --------------------------------------------------------------------------- #
# Chunked cross-entropy (never materializes (B, S, V) logits)
# --------------------------------------------------------------------------- #
def _ce_chunk(xc, w_head, lc, mc, rt: Runtime, vocab_size: int):
    sc = rt.sc
    logits = sc.constrain(accum_product(xc, w_head, rt),
                          sc.div(xc.shape[0], sc.dp_axes), None,
                          sc.div(w_head.shape[1], sc.tp_axis))
    if w_head.shape[1] != vocab_size:
        col = torch.arange(w_head.shape[1], device=logits.device)
        logits = torch.where(col < vocab_size, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)                       # (B, C)
    label = lc.clamp(min=0).long()[..., None]
    if is_dtensor(logits):
        # DTensor's gather over a sharded vocabulary leaves a masked
        # partial sum that it cannot reduce for a 3-d index: select the
        # label's logit by a mask instead (the same value: one term)
        col = torch.arange(logits.shape[-1], device=logits.device)
        ll = torch.where(col == label, logits, 0.0).sum(-1)
    else:
        ll = torch.gather(logits, -1, label)[..., 0]
    return ((lse - ll) * mc).sum(), (lse.square() * mc).sum()


def chunked_cross_entropy(x: torch.Tensor, w_head: torch.Tensor,
                          labels: torch.Tensor, mask: torch.Tensor,
                          rt: Runtime, vocab_size: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over masked positions + ``rt.z_loss`` times the mean squared
    log-normalizer; returns (loss, token count).

    x (B, S, d) final hidden; w_head (d, Vp), the padded columns past
    ``vocab_size`` masked to -1e30; labels, mask (B, S).  Runs over S in
    ``rt.ce_chunk`` chunks (one chunk of S when S is no multiple), each
    under ``torch.utils.checkpoint``, so the backward recomputes a chunk's
    logits instead of keeping them."""
    B, S, _ = x.shape
    C = min(rt.ce_chunk, S)
    if S % C != 0:
        C = S
    mf = mask.to(torch.float32)
    ce_sum = zl_sum = x.new_zeros((), dtype=torch.float32)
    for s0 in range(0, S, C):
        sl = slice(s0, s0 + C)
        ce, zl = checkpoint(_ce_chunk, x[:, sl], w_head, labels[:, sl],
                            mf[:, sl], rt, vocab_size, use_reentrant=False)
        ce_sum, zl_sum = ce_sum + ce, zl_sum + zl
    denom = mf.sum().clamp(min=1.0)
    return ce_sum / denom + rt.z_loss * zl_sum / denom, denom
