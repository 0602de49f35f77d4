"""Device-hygiene rules for eager PyTorch: hidden syncs, host control flow
on device values, silent device fallbacks.

The reference's device rules (REPRO-J101..J103) key on ``jnp``/``jax``/
``lax`` and ``@jax.jit``, so they see nothing in the port.  These are
their counterparts for eager PyTorch, scoped to the same files.  A hidden
sync blocks the host until the card has drained its queue: an ``.item()``,
a ``.cpu()``, a ``torch.nonzero`` (its output shape lives on the card), a
``float()`` of a tensor, an ``if t.any():``.  ``sanitizers.no_transfer``
catches them at run time; these rules catch them on the line.
``sanitizers.to_host`` is the sanctioned exit and ``to_device`` the
sanctioned upload.

Which values are on the device is inferred per function: a name assigned
from a ``torch.*`` call, a bank entry point (``bank_*``, ``fused_*``,
``fit_hypers*``), a kernel wrapper (``score_cov``, ``var_downdate``,
``tpe_scores``, ``parzen_logdens``) or ``to_device``, from an expression
over such names, or a parameter annotated ``torch.Tensor``.  Shape and
dtype reads (``t.shape``, ``t.dtype``, ``t.numel()``, ``len(t)``) are host
metadata and carry no taint.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set

from repro_torch.analysis.lint import (Finding, Module, Rule, call_name,
                                       terminal_name)
from repro_torch.analysis.rules import register

# fused-path files: where device values flow and host syncs hide
_DEVICE_FILES = ("gp.py", "acquisition.py", "tpe.py", "scoring.py",
                 "studybank.py", "kmeans.py", "kernels")

_DEVICE_TERMINAL_PREFIXES = ("bank_", "fused_", "fit_hypers", "score_cov",
                             "var_downdate", "tpe_scores", "parzen_logdens",
                             "to_device")
# torch calls that return host values or configure the runtime
_TORCH_HOST_PREFIXES = ("torch.device", "torch.cuda.", "torch.backends.",
                        "torch.Size", "torch.finfo", "torch.iinfo",
                        "torch.get_", "torch.is_", "torch.set_",
                        "torch.manual_seed", "torch.no_grad",
                        "torch.autograd.grad")
# methods and attributes that read host metadata of a tensor
_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
               "requires_grad"}
_META_METHODS = {"dim", "numel", "size", "data_ptr", "is_contiguous",
                 "element_size", "stride", "storage_offset"}
# calls whose result is a host value (the syncing ones are flagged apart)
_HOST_CALLS = {"to_host", "len", "isinstance", "type", "float", "int",
               "bool", "str", "repr"}
_HOST_METHODS = {"item", "tolist", "numpy", "cpu"} | _META_METHODS
# ops whose output shape depends on the data (read back to size it)
_DATA_SHAPED = {"nonzero", "unique", "unique_consecutive",
                "masked_select", "argwhere"}


def _is_device_call(call: ast.Call) -> bool:
    name = call_name(call)
    term = terminal_name(call)
    if name in _HOST_CALLS or term in _HOST_METHODS:
        return False
    if name.startswith(_TORCH_HOST_PREFIXES):
        return False
    if name.split(".", 1)[0] == "torch":
        return True
    return any(term.startswith(p) for p in _DEVICE_TERMINAL_PREFIXES)


def _is_data_shaped(call: ast.Call, tainted: Set[str]) -> bool:
    """``torch.nonzero(...)`` or ``t.nonzero()`` on a device value (and the
    other ops whose output shape depends on the data)."""
    if terminal_name(call) not in _DATA_SHAPED:
        return False
    if call_name(call).split(".", 1)[0] == "torch":
        return True
    return (isinstance(call.func, ast.Attribute)
            and _is_device_value(call.func.value, tainted))


def _is_device_value(expr: ast.AST, tainted: Set[str]) -> bool:
    """Is ``expr`` itself a device value, so that coercing it to a Python
    bool or number reads the card?  A device name or call, a method,
    subscript, arithmetic or comparison over one; not a metadata read,
    and not the result of a call this rule cannot see into (a helper such
    as ``_on_card(t)`` returns a host predicate)."""
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Call):
        if _is_device_call(expr):
            return True
        return (isinstance(expr.func, ast.Attribute)
                and terminal_name(expr) not in _HOST_METHODS
                and _is_device_value(expr.func.value, tainted))
    if isinstance(expr, ast.Attribute):
        return (expr.attr not in _META_ATTRS
                and _is_device_value(expr.value, tainted))
    if isinstance(expr, ast.Subscript):
        return _is_device_value(expr.value, tainted)
    if isinstance(expr, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return False
        return any(_is_device_value(e, tainted)
                   for e in [expr.left, *expr.comparators])
    if isinstance(expr, ast.BinOp):
        return (_is_device_value(expr.left, tainted)
                or _is_device_value(expr.right, tainted))
    if isinstance(expr, ast.UnaryOp):
        return _is_device_value(expr.operand, tainted)
    if isinstance(expr, ast.BoolOp):
        return any(_is_device_value(v, tainted) for v in expr.values)
    return False


def _feeds(expr: ast.AST, tainted: Set[str]) -> bool:
    """Does ``expr`` compute with a device value (so that a name assigned
    from it holds one)?  Metadata reads, host extractions and ``is None``
    tests do not."""
    if isinstance(expr, ast.Attribute) and expr.attr in _META_ATTRS:
        return False
    if isinstance(expr, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
        return False
    if isinstance(expr, ast.Call):
        if call_name(expr) in _HOST_CALLS \
                or terminal_name(expr) in _HOST_METHODS:
            return False
        if _is_device_call(expr):
            return True
    if isinstance(expr, ast.Name):
        return expr.id in tainted and isinstance(expr.ctx, ast.Load)
    if isinstance(expr, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
        return False
    return any(_feeds(c, tainted) for c in ast.iter_child_nodes(expr))


def _assign_targets(node) -> List[str]:
    out: List[str] = []

    def collect(t):
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                collect(e)

    if isinstance(node, ast.Assign):
        for t in node.targets:
            collect(t)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        collect(node.target)
    elif isinstance(node, ast.For):
        collect(node.target)
    return out


def _walk_scope(scope: ast.AST, module_level: bool):
    """Walk ``scope`` without descending into other function bodies."""
    stack = [scope]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if (isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and (module_level or child is not scope)):
                continue
            stack.append(child)


def _tensor_params(fn) -> Set[str]:
    out: Set[str] = set()
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return out
    for a in fn.args.args + fn.args.kwonlyargs + fn.args.posonlyargs:
        ann = a.annotation
        text = ann.value if isinstance(ann, ast.Constant) else (
            ast.unparse(ann) if ann is not None else "")
        if isinstance(text, str) and text.startswith(("torch.Tensor",
                                                      "Tensor")):
            out.add(a.arg)
    return out


def _scope_names(scope: ast.AST, module_level: bool):
    """(device names, data-shaped names) of ``scope``.  Two passes, so a
    name defined later in source order still taints earlier uses in
    loops; a host extraction clears a name's taint."""
    tainted: Set[str] = _tensor_params(scope)
    shaped: Set[str] = set()
    for _ in range(2):
        for node in _walk_scope(scope, module_level):
            if isinstance(node, ast.For):
                targets, value = _assign_targets(node), node.iter
            elif isinstance(node, (ast.Assign, ast.AugAssign,
                                   ast.AnnAssign)):
                targets, value = _assign_targets(node), node.value
            else:
                continue
            if value is None:
                continue
            if _feeds(value, tainted):
                tainted.update(targets)
            elif not isinstance(node, ast.AugAssign):
                tainted.difference_update(targets)
            if any(isinstance(n, ast.Call) and _is_data_shaped(n, tainted)
                   for n in ast.walk(value)):
                shaped.update(targets)
    return tainted, shaped


class _DeviceRule(Rule):
    family = "device-hygiene"
    scopes = _DEVICE_FILES

    def _names(self, mod: Module, node: ast.AST):
        """(device names, data-shaped names) of ``node``'s function."""
        fn = mod.enclosing_function(node)
        key = fn if fn is not None else mod.tree
        if key not in self._cache:
            self._cache[key] = _scope_names(key, module_level=fn is None)
        return self._cache[key]

    def check(self, mod: Module) -> Iterable[Finding]:
        self._cache = {}
        yield from self._check(mod)

    def _check(self, mod: Module) -> Iterable[Finding]:
        raise NotImplementedError


@register
class TorchHostSyncRule(_DeviceRule):
    id = "REPRO-T101"
    description = (".item()/.cpu()/.numpy()/.tolist()/torch.nonzero or "
                   "float()/int()/np.asarray on a device value in a fused "
                   "path — each is a hidden blocking device sync")
    rationale = ("The bank's steady state is sync-audited "
                 "(sanitizers.no_transfer): a hidden device->host read "
                 "stalls the host until the card drains its queue.  Leave "
                 "through sanitizers.to_host() at the one designed exit, "
                 "or keep the value on the device.  A Python scalar "
                 "written through a tensor index is copied to the card "
                 "synchronously too: write a 0-d device tensor.  The "
                 "counterpart of REPRO-J101.")

    def _check(self, mod: Module) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign):
                yield from self._scalar_store(mod, node)
                continue
            if not isinstance(node, ast.Call):
                continue
            tainted = self._names(mod, node)[0]
            name, term = call_name(node), terminal_name(node)
            recv = (node.func.value if isinstance(node.func, ast.Attribute)
                    else None)
            msg = None
            if recv is not None and term in ("item", "cpu", "numpy") \
                    and not node.args and not (
                        term == "numpy" and isinstance(recv, ast.Call)
                        and terminal_name(recv) == "cpu"):
                msg = (f".{term}() reads the device back — leave through "
                       "sanitizers.to_host() at the designed exit")
            elif recv is not None and term in ("tolist", "nonzero") \
                    and _is_device_value(recv, tainted):
                msg = (f".{term}() on a device value reads it back — "
                       "choose on the host or leave through to_host()")
            elif name in ("torch.nonzero", "torch.argwhere"):
                msg = (f"{name}() sizes its output from device data: a "
                       "sync — choose the rows on the host")
            elif name in ("float", "int", "np.asarray", "np.array",
                          "numpy.asarray", "numpy.array") and node.args \
                    and _is_device_value(node.args[0], tainted):
                msg = (f"{name}() on a device value is an implicit "
                       "device->host read — use sanitizers.to_host()")
            if msg is not None:
                yield self.finding(mod, node, msg)

    def _scalar_store(self, mod: Module, node: ast.Assign):
        value = node.value
        if isinstance(value, ast.UnaryOp):
            value = value.operand
        if not (isinstance(value, ast.Constant)
                and isinstance(value.value, (bool, int, float))):
            return
        tainted = self._names(mod, node)[0]
        for t in node.targets:
            if not (isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)):
                continue
            index = t.slice
            names = [n for n in ast.walk(index)
                     if isinstance(n, (ast.Name, ast.Call))]
            # a tensor index into a tensor: advanced indexing, whose
            # Python-scalar value is copied to the card first
            if names and (t.value.id in tainted or any(
                    _is_device_value(n, tainted) for n in names)):
                yield self.finding(
                    mod, node,
                    f"a Python scalar written into {t.value.id} through a "
                    "tensor index is copied to the card synchronously — "
                    "write a 0-d device tensor")


@register
class TorchHostControlFlowRule(_DeviceRule):
    id = "REPRO-T102"
    description = ("if/while/assert/bool() over a device value, or len() of "
                   "a data-shaped result (torch.nonzero, unique, ...) — "
                   "host control flow that reads the device back")
    rationale = ("Every pick loop of the port is an eager Python loop by "
                 "design; a loop costs a sync only when its control flow "
                 "reads the card, as `if t.any():` or `len(torch.nonzero"
                 "(m))` does, once per trip.  Decide on host counts.  "
                 "Replaces REPRO-J102, which flags every jnp call under "
                 "an eager loop: in the port that is every loop.")

    def _check(self, mod: Module) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            test, what = None, None
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                test, what = node.test, type(node).__name__.lower()
            elif isinstance(node, ast.Assert):
                test, what = node.test, "assert"
            elif isinstance(node, ast.Call) and node.args:
                name = call_name(node)
                if name == "bool":
                    test, what = node.args[0], "bool()"
                elif name == "len":
                    arg = node.args[0]
                    tainted, shaped = self._names(mod, node)
                    if ((isinstance(arg, ast.Name) and arg.id in shaped)
                            or any(isinstance(n, ast.Call)
                                   and _is_data_shaped(n, tainted)
                                   for n in ast.walk(arg))):
                        yield self.finding(
                            mod, node,
                            "len() of a data-shaped device result waits "
                            "for the card to size it — count on the host")
                    continue
            if test is None:
                continue
            if _is_device_value(test, self._names(mod, node)[0]):
                yield self.finding(
                    mod, node,
                    f"{what} over a device value reads it back to decide "
                    "on the host — decide on host counts or keep the "
                    "choice on the device (torch.where)")


@register
class SilentDeviceFallbackRule(_DeviceRule):
    id = "REPRO-T103"
    description = ("'cpu' chosen under torch.cuda.is_available() or in an "
                   "except handler, or an except around a kernel launch "
                   "that calls a plain ref. version — a silent fallback")
    rationale = ("The port never falls back: an entry point runs on the "
                 "card unless the caller passes device='cpu' "
                 "(device.resolve_device raises without a card), and a "
                 "CUDA tensor reaches its kernel or an exception "
                 "(kernels/build.py).  A fallback hides a missing card or "
                 "a broken kernel behind a slower, different answer.  "
                 "Replaces REPRO-J103: eager code has no jit closure to "
                 "guard.")

    def _check(self, mod: Module) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.If, ast.IfExp)) and any(
                    isinstance(n, ast.Call)
                    and call_name(n) == "torch.cuda.is_available"
                    for n in ast.walk(node.test)):
                branches = ([node.body, node.orelse]
                            if isinstance(node, ast.IfExp)
                            else node.body + node.orelse)
                if any(self._names_cpu(b) for b in branches):
                    yield self.finding(
                        mod, node,
                        "'cpu' chosen when no card is present — raise "
                        "(device.resolve_device) instead of falling back")
            elif isinstance(node, ast.ExceptHandler):
                if any(self._names_cpu(b) for b in node.body):
                    yield self.finding(
                        mod, node,
                        "'cpu' chosen in an except handler — a failure "
                        "on the card must surface, not move to the CPU")
            elif isinstance(node, ast.Try):
                if not any(self._launches(b) for b in node.body):
                    continue
                for h in node.handlers:
                    if any(isinstance(n, ast.Call) and self._is_ref(n)
                           for b in h.body for n in ast.walk(b)):
                        yield self.finding(
                            mod, h,
                            "except around a kernel launch runs the plain "
                            "version — a broken kernel must raise")

    @staticmethod
    def _names_cpu(node) -> bool:
        return any(isinstance(n, ast.Constant) and n.value == "cpu"
                   for n in ast.walk(node))

    @staticmethod
    def _launches(node) -> bool:
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            root = call_name(n).split(".", 1)[0]
            if (root in ("ops", "build") or root.endswith("_ops")
                    or terminal_name(n) in ("library", "load")):
                return True
        return False

    @staticmethod
    def _is_ref(call: ast.Call) -> bool:
        name = call_name(call)
        return name.split(".", 1)[0] == "ref" or name.endswith("_ref")
