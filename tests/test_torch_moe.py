"""PyTorch port, the MoE layer: capacity, routing, sort-based dispatch with
drops, shared experts, the auxiliary losses and the gradients, against the
JAX package's ``repro.models.moe`` on the same numpy-made inputs and
parameters (fp32).

Tolerances.  Outputs 1e-5 of the largest magnitude (the same products,
summed in other orders; measured below 1e-6); the auxiliaries 1e-6
relative; the drop share exactly (it counts slots); gradients 1e-4 of each
leaf's largest (sums over tokens of terms of both signs).  Routing on
near-tied router probabilities could pick another expert in the two
packages; the inputs here are drawn so that no token's k-th and (k+1)-th
probabilities are within 1e-5, which the test asserts rather than assumes.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import Runtime
from repro_torch.models import moe as moe_mod

T = torch.as_tensor
RT32 = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
OUT_RTOL = 1e-5
AUX_RTOL = 1e-6
GRAD_RTOL = 1e-4
MIN_GAP = 1e-5
AUX_KEYS = ("moe_lb_loss", "moe_router_z", "moe_drop_frac")

# (arch, capacity factor): qwen2-moe's shared experts, olmoe's top-4, the
# jamba layer, and a capacity factor low enough to drop tokens
CASES = [("qwen2-moe-a2.7b", 0.0), ("olmoe-1b-7b", 0.0),
         ("jamba-v0.1-52b", 0.0), ("olmoe-1b-7b", 0.5)]
IDS = ["qwen2-moe-shared", "olmoe", "jamba", "olmoe-drops"]


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _close(got, want, rtol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _layer(arch, cf, seed=0):
    """The reduced config's MoE parameters from the JAX package and the
    port's copy of them, with the runtimes of both."""
    jax, jnp = _jax()
    from repro.configs import get_config as jget
    from repro.models import Runtime as JRuntime
    from repro.models.moe import moe_init
    jcfg = jget(arch, reduced=True)
    jrt = JRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32,
                   moe_capacity_factor=cf)
    jp = moe_init(jax.random.PRNGKey(seed), jcfg, jrt)
    tp = jax.tree.map(lambda a: T(np.array(a, np.float32)), jp)
    rt = dataclasses.replace(RT32, moe_capacity_factor=cf)
    return jcfg, jrt, jp, get_config(arch, reduced=True), rt, tp


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _router_gap(p, x, cfg):
    probs = torch.softmax(T(x) @ p["router"], dim=-1)
    top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
    return float((top[..., -2] - top[..., -1]).min())


@pytest.mark.parametrize("S", [1, 7, 64, 130])
@pytest.mark.parametrize("cf", [0.0, 0.5, 2.0])
def test_moe_capacity_matches_reference(S, cf):
    _, jnp = _jax()
    from repro.configs import get_config as jget
    from repro.models import Runtime as JRuntime
    from repro.models.moe import moe_capacity
    for arch in ("qwen2-moe-a2.7b", "olmoe-1b-7b", "jamba-v0.1-52b"):
        want = moe_capacity(jget(arch), JRuntime(moe_capacity_factor=cf), S)
        got = moe_mod.moe_capacity(get_config(arch),
                                   Runtime(moe_capacity_factor=cf), S)
        assert got == want


@pytest.mark.parametrize("arch,cf", CASES, ids=IDS)
def test_moe_matches_reference(arch, cf):
    """Output and auxiliaries of one layer against the JAX package's."""
    _, jnp = _jax()
    from repro.models.moe import moe as jmoe
    jcfg, jrt, jp, cfg, rt, tp = _layer(arch, cf)
    x = _x(cfg, 2, 23, 1)
    assert _router_gap(tp, x, cfg) > MIN_GAP
    jy, jaux = jmoe(jp, jnp.asarray(x), jcfg, jrt, batch=2)
    y, aux = moe_mod.moe(tp, T(x), cfg, rt)
    _close(y.numpy(), np.asarray(jy), OUT_RTOL)
    for k in AUX_KEYS[:2]:
        _close(float(aux[k]), float(jaux[k]), AUX_RTOL)
    assert float(aux["moe_drop_frac"]) == pytest.approx(
        float(jaux["moe_drop_frac"]), abs=1e-7)
    if cf == 0.5:
        assert float(aux["moe_drop_frac"]) > 0.1   # the drop path runs


@pytest.mark.parametrize("arch,cf", [CASES[0], CASES[3]],
                         ids=[IDS[0], IDS[3]])
def test_moe_gradients_match_jax_grad(arch, cf):
    """Gradients of the output (weighted by a fixed cotangent) plus the
    weighted auxiliaries, as ``forward_train`` weighs them, with respect to
    every parameter and the input, against ``jax.grad``."""
    jax, jnp = _jax()
    from repro.models.moe import moe as jmoe
    jcfg, jrt, jp, cfg, rt, tp = _layer(arch, cf, seed=2)
    x = _x(cfg, 2, 17, 3)
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)
    assert _router_gap(tp, x, cfg) > MIN_GAP

    def jloss(p, xx):
        y, aux = jmoe(p, xx, jcfg, jrt, batch=2)
        return (jnp.sum(y * cot) + 0.01 * aux["moe_lb_loss"]
                + 0.001 * aux["moe_router_z"])

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    jflat = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    leaves, paths = [], []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tp)[0]:
        leaves.append(leaf.clone().requires_grad_())
        paths.append(path)
    p = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp),
                                     leaves)
    tx = T(x).requires_grad_()
    y, aux = moe_mod.moe(p, tx, cfg, rt)
    loss = ((y * T(cot)).sum() + 0.01 * aux["moe_lb_loss"]
            + 0.001 * aux["moe_router_z"])
    grads = torch.autograd.grad(loss, leaves + [tx])
    _close(grads[-1].numpy(), np.asarray(jgx), GRAD_RTOL)
    for path, g in zip(paths, grads[:-1]):
        _close(g.numpy(), np.asarray(jflat[path]), GRAD_RTOL)


def test_moe_init_shapes_and_dtypes():
    """The reference's layout and dtypes: the router in fp32 whatever the
    parameter dtype, shared experts and their gate only for qwen2-moe."""
    cfg = get_config("qwen2-moe-a2.7b", reduced=True)
    p = moe_mod.moe_init(torch.Generator().manual_seed(0), cfg, Runtime())
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    assert p["router"].dtype == torch.float32 and p["router"].shape == (d, E)
    assert p["wg"].shape == (E, d, f) and p["wd"].shape == (E, f, d)
    assert p["wg"].dtype == torch.bfloat16
    assert p["shared"]["w_up"].shape == (d, cfg.n_shared_experts * f)
    assert p["shared_gate"].shape == (d, 1)
    assert "shared" not in moe_mod.moe_init(
        torch.Generator(), get_config("olmoe-1b-7b", reduced=True),
        Runtime())
