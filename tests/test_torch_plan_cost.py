"""The port's plan cost model (``repro_torch.launch.cost.estimate_plan``,
``roofline.model_flops`` / ``roofline_terms`` / ``wire_bytes``) against the
JAX package's ``hlo_cost.estimate_plan`` and ``hlo_analysis``: with the
reference's TPU v5e constants passed as a ``Hardware`` record every
returned key equals the reference's over a grid of plans and cells; the
reference's six property tests hold on the default ``H100`` record; the
H100's two link rates charge a group that spans nodes at the network's
rate."""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses
import itertools
import math

import pytest

from repro.configs import cells, get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.launch import hlo_analysis, hlo_cost
from repro_torch.configs.registry import get_config, get_shape
from repro_torch.launch import cost, roofline
from repro_torch.launch.roofline import H100, Hardware

# the reference's figures, read from it (the port states none of them);
# one "node" holds every device, so every group goes at the one link rate
V5E = Hardware(name="reference", peak_flops=hlo_analysis.PEAK_FLOPS,
               hbm_bw=hlo_analysis.HBM_BW,
               hbm_bytes=hlo_cost.HBM_PER_CHIP_BYTES,
               link_bw=hlo_analysis.LINK_BW,
               cross_node_bw=hlo_analysis.LINK_BW, gpus_per_node=1 << 20)
CELLS = [(a, s) for a, s, _, _ in cells(include_skips=False)]
PLANS = [dict(tp=tp, zero=zero, remat=remat, micro=micro, seq_parallel=sp,
              ep=ep, capacity_factor=cf)
         for tp, zero, remat, micro, sp, ep, cf in itertools.product(
             (1, 4, 16, 7), ("zero1", "zero3"), ("none", "dots", "full"),
             (1, 8), (False, True), (False, True), (0.0, 2.0))]


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("arch,shape_id", CELLS)
def test_estimate_plan_matches_the_reference(arch, shape_id):
    """Every key to 1e-12 relative, for each plan of the grid, on 256 and
    512 devices; model_flops equal."""
    cfg, shape = get_config(arch), get_shape(shape_id)
    jcfg, jshape = jget_config(arch), jget_shape(shape_id)
    assert roofline.model_flops(cfg, shape) == hlo_analysis.model_flops(
        jcfg, jshape)
    for plan, n in itertools.product(PLANS, (256, 512)):
        got = cost.estimate_plan(cfg, shape, plan, n, hw=V5E)
        want = hlo_cost.estimate_plan(jcfg, jshape, plan, n)
        assert got.keys() == want.keys()
        assert _close(got, want), (plan, n, got, want)


def test_roofline_terms_and_wire_factors_match_the_reference():
    for kind in roofline.COLL_KINDS:
        for g in (1, 2, 16, 256):
            assert roofline.wire_bytes(kind, 1e6, g) == hlo_cost._wire(
                kind, 1e6, g)
    for f, b, w in ((1e15, 1e9, 1e8), (1e9, 1e12, 0.0), (0.0, 0.0, 1e9)):
        assert roofline.roofline_terms(f, b, w, V5E) == \
            hlo_analysis.roofline_terms(f, b, w)


# ---- the reference's property tests (tests/test_hlo_cost.py) on H100 ----
def _plan_env():
    return get_config("yi-34b"), get_shape("train_4k")


def test_estimate_plan_returns_finite_roofline():
    """The reference's property on one H100 node (8 devices on NVLink):
    compute or memory dominates.  On 256 devices the gradient sync crosses
    nodes at the network's 50 GB/s and the collective term dominates."""
    cfg, shape = _plan_env()
    plan = {"tp": 4, "zero": "zero3", "remat": "dots", "micro": 2}
    for n in (8, 256):
        est = cost.estimate_plan(cfg, shape, plan, n)
        assert est["feasible"] and est["t_step_s"] > 0
        assert est["t_step_s"] >= max(est["t_compute_s"],
                                      est["t_memory_s"])
        assert est["hbm_gb"] > 0 and math.isfinite(est["t_step_s"])
        assert est["dominant"] == ("t_collective_s" if n == 256 else
                                   "t_compute_s")


def test_estimate_plan_tp_must_divide_devices():
    cfg, shape = _plan_env()
    est = cost.estimate_plan(cfg, shape, {"tp": 7}, 256)
    assert not est["feasible"] and est["t_step_s"] == float("inf")
    assert not est["fits"]


def test_estimate_plan_remat_trades_flops_for_hbm():
    cfg, shape = _plan_env()
    plans = {r: cost.estimate_plan(cfg, shape, {"tp": 8, "remat": r}, 256)
             for r in ("none", "dots", "full")}
    assert plans["none"]["t_compute_s"] < plans["dots"]["t_compute_s"] \
        < plans["full"]["t_compute_s"]
    assert plans["none"]["hbm_gb"] > plans["dots"]["hbm_gb"] \
        > plans["full"]["hbm_gb"]


def test_estimate_plan_zero3_shards_params_for_wire_time():
    cfg, shape = _plan_env()
    z1 = cost.estimate_plan(cfg, shape, {"zero": "zero1", "micro": 4}, 256)
    z3 = cost.estimate_plan(cfg, shape, {"zero": "zero3", "micro": 4}, 256)
    assert z3["t_collective_s"] > z1["t_collective_s"]
    assert z3["hbm_gb"] < z1["hbm_gb"]


def test_estimate_plan_ep_costs_wire_only_on_moe():
    shape = get_shape("train_4k")
    moe = get_config("qwen2-moe-a2.7b")
    base = cost.estimate_plan(moe, shape, {"tp": 1}, 256)
    ep = cost.estimate_plan(moe, shape, {"tp": 1, "ep": True}, 256)
    assert ep["t_collective_s"] > base["t_collective_s"]
    dense = get_config("yi-34b")
    d0 = cost.estimate_plan(dense, shape, {"tp": 1}, 256)
    d1 = cost.estimate_plan(dense, shape, {"tp": 1, "ep": True}, 256)
    assert d1["t_collective_s"] == d0["t_collective_s"]


def test_estimate_plan_deterministic():
    cfg, shape = _plan_env()
    plan = {"tp": 4, "zero": "zero3", "remat": "full",
            "micro": 8, "seq_parallel": True}
    assert cost.estimate_plan(cfg, shape, plan, 256) == \
        cost.estimate_plan(cfg, shape, plan, 256)


# ---- the H100 record ----
def test_h100_record_and_its_two_link_rates():
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_bytes) == (
        989e12, 3.35e12, 80e9)
    assert (H100.link_bw, H100.cross_node_bw, H100.gpus_per_node) == (
        450e9, 50e9, 8)
    cfg, shape = _plan_env()
    # tensor parallelism inside a node goes at NVLink's rate, across nodes
    # at the network's: the same wire takes 9x longer at tp 16 than it
    # would at NVLink rates
    inside = cost.estimate_plan(cfg, shape, {"tp": 8}, 8)
    across = cost.estimate_plan(cfg, shape, {"tp": 16}, 16)
    one_node = dataclasses.replace(H100, gpus_per_node=16)
    nv = cost.estimate_plan(cfg, shape, {"tp": 16}, 16, hw=one_node)
    assert inside["t_collective_s"] > 0
    assert across["t_collective_s"] == pytest.approx(
        nv["t_collective_s"] * H100.link_bw / H100.cross_node_bw)
    # with every device in one node there is one rate, the reference's rule
    flat = dataclasses.replace(H100, gpus_per_node=1 << 20)
    est = cost.estimate_plan(cfg, shape, {"tp": 4}, 256, hw=flat)
    assert est["t_collective_s"] > 0
