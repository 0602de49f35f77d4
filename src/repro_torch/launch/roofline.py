"""Roofline terms of a step on an NVIDIA H100 fleet: the card's figures, the
useful FLOPs of a cell, and the wire bytes of collectives.

The counterpart of ``repro.launch.hlo_analysis`` (``model_flops``,
``roofline_terms``) and of the ring wire factors of
``repro.launch.hlo_cost``.  There is no HLO to parse: the collectives come
from a traced run (``launch.dryrun --trace``, its ``CollectiveLog``), each
with its kind, the bytes of its local output and its process group.

The card's figures live in one frozen ``Hardware`` record, ``H100`` by
default.  An H100 fleet has two link rates where the reference's pod has
one: NVLink 4 between the ``gpus_per_node`` cards of a node, and the
network between nodes.  A group whose ranks all lie within one node is
charged at the first, any other at the second; a record with
``gpus_per_node`` at least the device count has the single rate back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float        # dense bf16 FLOP/s per device
    hbm_bw: float            # bytes/s per device
    hbm_bytes: float         # device memory
    link_bw: float           # bytes/s per device per direction, in a node
    cross_node_bw: float     # bytes/s per device per direction, across nodes
    gpus_per_node: int


# NVIDIA H100 SXM (data sheet, dense rates): 989 TFLOP/s bf16, 3.35 TB/s
# HBM3, 80 GB; NVLink 4 at 900 GB/s per GPU both ways, 450 GB/s a direction,
# eight GPUs a node; one 400 Gb/s NDR InfiniBand port per GPU across nodes
H100 = Hardware(name="NVIDIA H100 SXM", peak_flops=989e12, hbm_bw=3.35e12,
                hbm_bytes=80e9, link_bw=450e9, cross_node_bw=50e9,
                gpus_per_node=8)

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")


def wire_bytes(kind: str, out_bytes: float, g: int) -> float:
    """Per-device bytes on the wire of a ring collective over a group of
    ``g`` with ``out_bytes`` of local output."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-reduce":
        return out_bytes * 2 * (g - 1) / g
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    return out_bytes  # collective-permute


def within_node(span: int, hw: Hardware) -> bool:
    """Whether a group whose ranks span ``span`` consecutive devices lies in
    one node."""
    return span <= hw.gpus_per_node


def model_flops(cfg, shape) -> float:
    """Theoretically-useful FLOPs for this (arch, shape) cell.

    6*N_active*D (train) / 2*N_active*D (prefill) / 2*N_active*B (decode)
    plus exact-causal attention score/value FLOPs (which 6ND ignores and
    which dominate small-d archs at long S).
    """
    pc = cfg.param_count()
    B, S = shape.global_batch, shape.seq_len
    n_attn = sum(1 for s in cfg.period if s.mixer == "attn") * cfg.n_periods
    Hhd = cfg.n_heads * cfg.hd
    if shape.kind == "train":
        base = 6 * pc["active"] * B * S
        attn = 3 * n_attn * 2 * B * S * S * Hhd  # causal: 0.5 * 4BS^2
        if cfg.encoder_layers:
            Se = cfg.encoder_seq
            attn += 3 * cfg.encoder_layers * 4 * B * Se * Se * Hhd  # bidir
            attn += 3 * n_attn * 4 * B * S * Se * Hhd               # cross
        return base + attn
    if shape.kind == "prefill":
        base = 2 * pc["active"] * B * S
        attn = n_attn * 2 * B * S * S * Hhd
        if cfg.encoder_layers:
            Se = cfg.encoder_seq
            attn += cfg.encoder_layers * 4 * B * Se * Se * Hhd
            attn += n_attn * 4 * B * S * Se * Hhd
        return base + attn
    # decode: one token against an S-long cache
    base = 2 * pc["active"] * B
    attn = n_attn * 4 * B * S * Hhd
    if cfg.encoder_layers:
        attn += n_attn * 4 * B * cfg.encoder_seq * Hhd
    return base + attn


def roofline_terms(flops_per_device: float, hbm_bytes_per_device: float,
                   wire_bytes_per_device: float, hw: Hardware = H100,
                   cross_node_wire_bytes: float = 0.0) -> Dict[str, float]:
    """Compute, memory and collective times of one device; wire bytes in a
    node go at ``hw.link_bw``, ``cross_node_wire_bytes`` at
    ``hw.cross_node_bw``."""
    t_compute = flops_per_device / hw.peak_flops
    t_memory = hbm_bytes_per_device / hw.hbm_bw
    t_coll = (wire_bytes_per_device / hw.link_bw
              + cross_node_wire_bytes / hw.cross_node_bw)
    terms = {"t_compute_s": t_compute, "t_memory_s": t_memory,
             "t_collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom
    terms["roofline_fraction"] = t_compute / bound if bound > 0 else 0.0
    return terms
