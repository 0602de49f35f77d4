"""Carry state between the JAX package and the port.

The tuner's state is the study ledger (carried by the shared ``.npz``
checkpoint format, see ``StudyBank.load``) and the GP observation stage.
``bank_state_from_numpy`` takes the observation-stage arrays as
``repro.core.StudyBank._obs_stage`` caches them, fetched to numpy, and
returns the port's tensors under the same names, ready for
``gp.bank_pick`` / ``gp.bank_absorb``.  One study's GP moves with
``gp_state_from_numpy`` / ``gp_state_to_numpy`` (a ``GPState``: padded
buffers, factors, hyperparameters, host scalars) and
``gaussian_process_from_numpy`` / ``gaussian_process_to_numpy`` (the
facade: its state, fit schedule and observed history), so both packages
can pick from one fitted state.

The model stack's state is its parameters and, in training, the AdamW
moments and step (and the error-feedback buffer).  The JAX package stacks
each period position's leaves on a leading ``n_periods`` axis under
``blocks/pos<i>``, and whisper's encoder leaves on a leading
``encoder_layers`` axis under ``enc_blocks`` (no ``pos<i>`` level); the
port keeps one dict per layer in the lists ``blocks`` (layer ``p * P + i``
is period ``p``, position ``i``) and ``enc_blocks``.
``to_jax_layout`` and ``from_jax_layout`` move a tree between the two;
``model_params_from_numpy`` and ``train_state_from_numpy`` build the
port's tensors from the JAX package's arrays, and ``train_state_to_numpy``
goes back, so that both packages compute on the same state and a
checkpoint written by either restores into the other.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.checks import is_dtensor
from repro_torch.models.common import Runtime
from repro_torch.models import mamba, moe, xlstm
from repro_torch.models.transformer import layer_specs
from repro_torch.tree import tree_map

BANK_STATE_KEYS = ("Xs", "z", "mask", "L", "Linv", "ls", "var", "noise")


def bank_state_from_numpy(arrays: Dict[str, np.ndarray],
                          device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """float32, contiguous tensors on ``device`` for every key of
    ``BANK_STATE_KEYS``: Xs (B, na, dp), z and mask (B, na), L and Linv
    (B, na, na), ls (B, d), var and noise (B,)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(arrays[k], np.float32),
                               device=dev).contiguous()
            for k in BANK_STATE_KEYS}


# --------------------------------------------------------------------------- #
# one study's GP
# --------------------------------------------------------------------------- #
GP_STATE_ARRAYS = ("X", "y", "mask", "L", "ls", "var", "noise", "Linv")
GP_STATE_SCALARS = ("n", "y_mean", "y_std")


def gp_state_from_numpy(arrays: Dict[str, Any], device: DeviceLike = None):
    """A ``repro_torch.core.gp.GPState`` on ``device`` from the fields of
    the JAX package's ``GPState`` as numpy arrays and host scalars
    (``GP_STATE_ARRAYS``, ``Linv`` may be None, and ``GP_STATE_SCALARS``)."""
    from repro_torch.core.gp import GPState
    dev = resolve_device(device)
    t = {k: None if arrays.get(k) is None else torch.as_tensor(
        np.array(arrays[k], np.float32), device=dev)
        for k in GP_STATE_ARRAYS}
    return GPState(n=int(arrays["n"]), y_mean=float(arrays["y_mean"]),
                   y_std=float(arrays["y_std"]), **t)


def gp_state_to_numpy(st) -> Dict[str, Any]:
    """The inverse of ``gp_state_from_numpy``."""
    out = {k: None if getattr(st, k) is None
           else getattr(st, k).detach().cpu().numpy()
           for k in GP_STATE_ARRAYS}
    out.update(n=st.n, y_mean=st.y_mean, y_std=st.y_std)
    return out


GP_FIELDS = ("dim", "fit_steps", "warm_fit_steps", "refit_every",
             "track_factor", "n_fit")


def gaussian_process_from_numpy(fields: Dict[str, Any],
                                device: DeviceLike = None):
    """A ``repro_torch.core.gp.GaussianProcess`` on ``device`` from a JAX
    package ``GaussianProcess`` as plain data: ``GP_FIELDS``, ``state``
    (``gp_state_from_numpy``'s input or None), ``fit_params`` (the log
    hyperparameters of the last fit or None) and ``obs_X`` / ``obs_y``
    (the observed history or None).  It then observes, picks and exports
    as the original would."""
    from repro_torch.core.gp import GaussianProcess
    g = GaussianProcess(fields["dim"], fit_steps=fields["fit_steps"],
                        refit_every=fields["refit_every"],
                        track_factor=fields["track_factor"],
                        warm_fit_steps=fields["warm_fit_steps"],
                        device=device)
    g.n_fit = int(fields["n_fit"])
    if fields.get("state") is not None:
        g.state = gp_state_from_numpy(fields["state"], g.device)
    fp = fields.get("fit_params")
    g._fit_params = None if fp is None else {
        k: torch.as_tensor(np.array(v, np.float32), device=g.device)
        for k, v in fp.items()}
    for k in ("obs_X", "obs_y"):
        v = fields.get(k)
        setattr(g, "_" + k, None if v is None else np.asarray(v, np.float32))
    return g


def gaussian_process_to_numpy(g) -> Dict[str, Any]:
    """The inverse of ``gaussian_process_from_numpy``."""
    out = {k: getattr(g, k) for k in GP_FIELDS}
    out["state"] = None if g.state is None else gp_state_to_numpy(g.state)
    out["fit_params"] = None if g._fit_params is None else {
        k: v.detach().cpu().numpy() for k, v in g._fit_params.items()}
    out["obs_X"], out["obs_y"] = g._obs_X, g._obs_y
    return out


# --------------------------------------------------------------------------- #
# the stacked (JAX) and per-layer (port) layouts of a parameter tree
# --------------------------------------------------------------------------- #
_STACKED = ("blocks", "enc_blocks")


def from_jax_layout(tree: Dict[str, Any], cfg: ArchConfig,
                    leaf: Callable = lambda path, a: a) -> Dict[str, Any]:
    """A JAX-layout tree (``blocks/pos<i>`` leaves stacked over periods,
    ``enc_blocks`` leaves over encoder layers) to the port's (``blocks``
    and ``enc_blocks`` lists of per-layer dicts).  ``leaf(path, a)`` makes
    each leaf; ``path`` is its path in the port's tree."""
    P = len(cfg.period)

    def layer(key, sub, l, i):
        return tree_map(lambda path, a: leaf(path, np.asarray(a)[i]), sub,
                        path=(key, l), with_path=True)

    out = {k: tree_map(leaf, v, path=(k,), with_path=True)
           for k, v in tree.items() if k not in _STACKED}
    out["blocks"] = [layer("blocks", tree["blocks"][f"pos{l % P}"], l,
                           l // P) for l in range(cfg.n_layers)]
    if "enc_blocks" in tree:
        out["enc_blocks"] = [layer("enc_blocks", tree["enc_blocks"], l, l)
                             for l in range(cfg.encoder_layers)]
    return out


def to_jax_layout(tree: Dict[str, Any], cfg: ArchConfig,
                  leaf: Callable[[Any], np.ndarray]) -> Dict[str, Any]:
    """The port's tree to the JAX layout: ``leaf`` maps each port leaf to a
    numpy array; block leaves are stacked over the periods, encoder leaves
    over the encoder layers."""
    P = len(cfg.period)

    def stack(layers):
        return tree_map(lambda *ls: np.stack([leaf(x) for x in ls]), *layers)

    out = {k: tree_map(leaf, v) for k, v in tree.items()
           if k not in _STACKED}
    blocks = tree["blocks"]
    out["blocks"] = {f"pos{i}": stack(blocks[i::P]) for i in range(P)}
    if "enc_blocks" in tree:
        out["enc_blocks"] = stack(tree["enc_blocks"])
    return out


# per block sub-tree ("mixer" by mixer kind, "ffn" by FFN kind), the leaves
# the reference keeps in fp32 whatever the parameter dtype
FP32_PARAMS = {("mixer", "mlstm"): xlstm.FP32_PARAMS["mlstm"],
               ("mixer", "slstm"): xlstm.FP32_PARAMS["slstm"],
               ("mixer", "mamba"): mamba.FP32_PARAMS,
               ("ffn", "moe"): moe.FP32_PARAMS}


def param_dtype(path, cfg: ArchConfig, rt: Runtime) -> torch.dtype:
    """The dtype the port keeps a parameter in: ``rt.param_dtype``, except
    the leaves the reference keeps in fp32: the xLSTM gate and recurrent
    leaves, Mamba's ``dt_bias``, ``A_log`` and ``D``, and the MoE router
    (whisper's encoder layers have none of these)."""
    if len(path) == 4 and path[0] == "blocks":
        spec = layer_specs(cfg)[path[1]]
        kind = spec.mixer if path[2] == "mixer" else spec.ffn
        if path[3] in FP32_PARAMS.get((path[2], kind), ()):
            return torch.float32
    return rt.param_dtype


def numpy_to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor of ``dtype`` on ``device`` from a numpy array: float32 (or
    any real type), or the raw two-byte void type that numpy gives for the
    bfloat16 arrays JAX writes to ``.npz`` without ml_dtypes loaded."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return t.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(a, np.float32), device=device).to(dtype)


def tensor_to_numpy(t) -> np.ndarray:
    """float32 numpy of a tensor (bfloat16 widens exactly; JAX casts it back
    on restore); a DTensor is gathered whole first (a collective every rank
    of its mesh joins)."""
    if is_dtensor(t):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy()


def model_params_from_numpy(params_np: Dict[str, Any], cfg: ArchConfig,
                            rt: Runtime,
                            device: DeviceLike = None) -> Dict[str, Any]:
    """The port's parameters from the JAX package's ``init_params`` pytree
    with numpy leaves (float32, or bfloat16 as JAX fetches it), each cast to
    the dtype the port keeps it in (``param_dtype``)."""
    dev = resolve_device(device)
    return from_jax_layout(
        params_np, cfg,
        lambda path, a: numpy_to_tensor(a, param_dtype(path, cfg, rt), dev))


def train_state_from_numpy(state_np: Dict[str, Any], cfg: ArchConfig,
                           rt: Runtime,
                           device: DeviceLike = None) -> Dict[str, Any]:
    """The port's train state from the JAX package's (``params``, ``opt``
    with ``m``, ``v`` and ``step``, and ``ef`` when present) with numpy
    leaves."""
    dev = resolve_device(device)
    f32 = lambda path, a: numpy_to_tensor(a, torch.float32, dev)  # noqa
    opt = state_np["opt"]
    out = {"params": model_params_from_numpy(state_np["params"], cfg, rt,
                                             dev),
           "opt": {"m": from_jax_layout(opt["m"], cfg, f32),
                   "v": from_jax_layout(opt["v"], cfg, f32),
                   "step": int(np.asarray(opt["step"]))}}
    if "ef" in state_np:
        out["ef"] = from_jax_layout(state_np["ef"], cfg, f32)
    return out


def train_state_to_numpy(state: Dict[str, Any],
                         cfg: ArchConfig) -> Dict[str, Any]:
    """The port's train state in the JAX package's layout, float32 numpy
    leaves and an int32 step."""
    def tree(t):
        return to_jax_layout(t, cfg, tensor_to_numpy)

    out = {"params": tree(state["params"]),
           "opt": {"m": tree(state["opt"]["m"]), "v": tree(state["opt"]["v"]),
                   "step": np.asarray(state["opt"]["step"], np.int32)}}
    if "ef" in state:
        out["ef"] = tree(state["ef"])
    return out


def flatten_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """A nested dict flattened to "/"-joined keys, as the JAX package's
    checkpoints name their leaves."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_paths(v, key + "/"))
        else:
            flat[key] = v
    return flat


def unflatten_paths(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        parts: List[str] = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out
