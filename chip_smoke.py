#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase; needs one CUDA card
    python3 chip_smoke.py --profile       # every phase, then profiled asks,
                                          # serving and training steps

Phases:
  1. setup: card name and power limit, build the CUDA kernels of the five
     suites (``src/repro_torch/kernels/{gp_acquisition,tpe_kde,
     flash_attention,mlstm_chunk,ssm_scan}/csrc``) with nvcc (sm_90a), one
     nvcc each, started together, and print what ptxas says about them and
     each score_cov, TPE, flash and mLSTM kernel's registers, spills and
     shared memory;
  2. each kernel against its plain PyTorch version on the card, with
     timings: the GP kernels at the fleet path's shape and at a shape for
     every branch of score_cov (``GP_KERNEL_SHAPES``), score_cov run twice
     at the fleet shape and required bitwise equal, its square root held
     equal to sqrtf on every float from 1e-12 up, its bound counted with
     the product K L^-T at the split-TF32 rate; the fit's kernels
     (``masked_kernel``, ``fit_grad``) at the cells' shape, a ragged shape
     and one tile (``FIT_KERNEL_SHAPES``), run twice at the cells' shape and
     required bitwise equal; the TPE kernels at the fleet path's shapes, one study of it, a ragged small shape, a large
     bucket and fractional weights with a row in both splits, each shape
     run twice and required bitwise equal;
     flash attention at the served
     models' prefill shapes, yi-34b's width, a ragged and a cross shape in
     fp32 (the FMA kernel) and bf16 (the tensor-core kernel), causal
     Sq < Sk at hd 24, MQA at hd 128 and whisper-large-v3's encoder,
     beside ``scaled_dot_product_attention`` as a yardstick, each bf16
     shape run twice and required bitwise equal; both flash kernels with a
     given causal diagonal (``FLASH_OFFSET_SHAPES``: a key shard whose
     first rows see no key, a row shard, Sq > Sk; fp32 and bf16) against
     the plain version, no NaN, bf16 bitwise repeatable; the mLSTM
     forward and backward kernels at xlstm-1.3b's training shape, a reduced
     head size, a ragged length and a case where the clamp decides, beside
     the bound of their split-TF32 products and state workspace, with each
     stage kernel's device time and two runs required bitwise equal at
     xlstm-1.3b's shape; the
     selective-scan forward (with and without the final state) and backward
     kernels at jamba's training shape, a reduced width, a ragged length,
     the kernel tests' decaying draw and an Abar near zero; the flash
     backward at jamba's attention shape, phi3-mini's prefill shape, a
     ragged length and head size 16 (fp32 and bf16) and a non-causal cross
     shape, beside the library's backward, bf16 runs required bitwise
     equal;
  3. the GP fleet: a 64-study ``StudyBank`` over Hartmann-6 with the default
     candidate budget, 200 observations each, three rounds of ask_all(4) ->
     tell, with the kernels' launch counts read around the run;
  4. the TPE fleet: the same fleet with ``optimizer="tpe"``, three rounds,
     then once more with ``pending_penalty=True`` and a batch left in
     flight; ``tpe_scores`` launches once per ask;
  5. a mixed fleet of 32 ``bayesian`` and 32 ``tpe`` studies, one round:
     both families launch their kernels;
  6. the paper's Fig. 3 setting (mixed Branin) through ``Tuner``: GP-BUCB
     batch 5; TPE serial and batch 5; TPE through ``AsyncTuner``; every TPE
     best value equals the CPU port's on the same seed;
  7. one full-size ask, with a batch of trials in flight, from the phase-3
     (GP) and phase-4 (TPE) states on the card and on the CPU (plain
     versions); picks must agree except on near-ties, judged by float64
     numpy evaluations of the same surfaces;
  8. serving (``repro_torch.launch.serve.run``), bf16, full width and depth:
     smollm-135m at B 8 with a 1024-token and a ragged 1000-token prompt,
     phi3-mini-3.8b at B 4 with a 2048-token prompt, 32 generated tokens
     each; the flash kernel launches once per layer in prefill and never in
     decode;
  9. fp32 smollm-135m (full width and depth) on the card and on the CPU
     plain path from the same parameters: logits within a tolerance, greedy
     picks equal except on near-ties;
 10. training (``repro_torch.launch.train.run``): xlstm-1.3b at full width
     and depth (48 layers: 42 mLSTM, 6 sLSTM), bf16, B 2, S 1024, four
     AdamW steps with finite losses and grad norms; the mLSTM forward and
     backward kernels launch once per mLSTM layer per step each;
 11. the reduced xLSTM trained 5 fp32 steps on the card, each step also
     run on the CPU plain path from a copy of the card's state: losses and
     grad norms within a tolerance;
 12. xlstm-1.3b served at full width and depth in bf16 (B 2, a 256-token
     prompt, 8 tokens): stateful prefill and decode, no kernel;
 13. training: jamba-v0.1-52b at full width, its period cut to one Mamba +
     dense, one Mamba + MoE and one attention + dense layer, bf16, B 1,
     S 2048, four AdamW steps with finite losses and grad norms; per step
     the scan's forward and backward kernels launch once per Mamba layer
     and the flash forward and backward once per attention layer;
 14. the reduced jamba trained 5 fp32 steps on the card, each step also
     run on the CPU plain path from a copy of the card's state, with phase
     11's tolerances;
 15. the cut jamba served in bf16 (B 2, a 1024-token prompt, 16 tokens):
     one scan launch per Mamba layer and one flash launch in prefill, none
     in decode; then the reduced fp32 jamba's logits card vs CPU;
 16. whisper-large-v3 served at full width and depth in bf16 (B 8, 1500
     stub frames, a 64-token prompt, 64 tokens): 96 flash launches in
     prefill (32 encoder layers, 32 decoder self- and 32 cross-attentions),
     none in decode;
 17. whisper-large-v3 trained at full width and depth, bf16, B 4, 1500
     frames, S 448, four AdamW steps: finite losses and grad norms, 96
     flash forward and 96 backward launches per step, peak memory below
     76 GiB;
 18. the reduced whisper trained 5 fp32 steps on the card, each step also
     on the CPU from a copy of the card's state (phase 11's tolerances);
     then fp32 logits card vs CPU of whisper at full width cut to 4
     encoder + 4 decoder layers (B 2, 1500 frames, a 64-token prompt);
 19. clustering: phase 3's fleet with ``optimizer="clustering"``, three
     rounds, ``score_cov`` once per ask; a mixed fleet of 22 GP, 21 TPE and
     21 clustering studies, one round, every family's kernels launching;
     phase 7's card-vs-CPU parity on the clustering fleet, near-ties
     judged by a float64 replay of the pick; ``Tuner(optimizer=
     "clustering")`` batch 5 on phase 6's mixed Branin;
 20. the fault-tolerant schedulers and the durable service: (a)
     ``Tuner`` (GP, batch 5 x 3) on phase 6's mixed Branin through
     ``ProcessScheduler`` while this process holds a CUDA context, each
     trial computed on the card in a spawned worker, with each batch's
     wall and a two-worker pool's start by spawn and by forkserver; (b)
     ``Tuner`` (GP) and ``AsyncTuner`` (TPE) over ``TaskQueueScheduler``
     with injected failures and stragglers, the dropped submit sequences
     equal to the CPU port's; (c) the service at a fleet's size over HTTP
     on the card (64 studies: 22 GP, 21 TPE, 21 clustering; 40
     observations each, one compaction, 3 rounds of ask(4) -> tell): ask
     latency over HTTP and in the bank, journal ms an op, the launches;
     a restart on its data dir JSON-equal to an uninterrupted twin and its
     next asks bit-equal; (d) the chaos grid (5 seeded SIGKILLs of server
     subprocesses on the card against an in-process oracle on the card).

 21. the single-study strategy paths: (a) one study of phase 3's stream
     (200 observations, 16,800 candidates, batch 4, 0 and 3 in flight):
     ``HallucinationStrategy`` (``hallucination_ref``) and
     ``FusedHallucinationStrategy`` with the ``chol`` and ``kinv_pallas``
     scorers, ``ClusteringStrategy.propose`` and ``propose_host``,
     ``TPEStrategy.propose`` with the pending penalty off and on; card vs
     CPU picks from one fitted GP (phase 7's oracles, phase 19's replay),
     each ask's launches of kernels 1-3 as the reference's dispatch implies,
     the median of five card asks, the condition estimate card vs CPU; (b)
     ``Tuner(optimizer="hallucination_ref")`` on the factor core, phase 6's
     mixed Branin batch 5 x 15, and the same run checkpointed at iteration
     7 and resumed by a fresh Tuner, trying the same configurations; (c)
     the four examples (``repro_torch.examples``) on the card.

 22. the steady-state contract under the sanitizers
     (``repro_torch.analysis.sanitizers``): (a) ``analysis.smoke.run`` on
     the card at the reference's size; (b) phase 3's fleet as GP, TPE
     (pending penalty on) and clustering families, each warmed, then three
     ask -> tell rounds and an ask with a batch in flight (``bank_absorb``)
     under ``no_transfer()`` and ``no_retrace()``: no hidden sync, no new
     signature of a bank entry point and no kernel build, each family's
     launches as ``SANITIZE_LAUNCHES``; each fleet's ask wall with a batch in
     flight; (c) the negative controls on the GP fleet: an injected
     ``.item()`` inside ``no_transfer()`` and an ask of another batch size
     inside ``no_retrace()`` both raise.

 23. the launch layer (``repro_torch.launch.{mesh,sharding,cost,dryrun}``):
     a one-rank NCCL process group (a ``FileStore`` under ``build/``) and a
     (data=1, model=1) ``DeviceMesh``; (a) smollm-135m at full width and
     depth in bf16 (B 8, S 1024, remat none), four AdamW steps with DTensor
     state placed by ``param_specs`` beside the plain step from the same
     state, losses and grad norms within phase 11's tolerances, 30 flash
     forward and 30 backward launches per DTensor step (the kernel on each
     rank's shard through ``local_map``); (b) a 1024-token prefill and 16
     greedy tokens with a DTensor cache placed by ``cache_specs``, tokens
     equal to the plain path's but on near-ties; (c) the step's wall and
     peak memory beside ``estimate_plan(..., n_devices=1)``, its ``fits``
     held against the peak and the card's memory; (d) ``compressed_psum``
     over the data group on NCCL against the local quantise-dequantise;
     (e) the DTensor state saved and restored onto its placements,
     bitwise; (f) in CPU subprocesses started with the phase, the analytic
     dry run of all 64 cells and smollm-135m ``train_4k`` traced on a fake
     256- and 512-rank process group, every cell OK.
 24. the MoE, Mamba, xLSTM and whisper paths on phase 23's one-rank mesh:
     olmoe-1b-7b (2 layers, the expert-parallel layout), jamba-v0.1-52b
     ((Mamba, dense) + (attention, dense)), xlstm-1.3b (one mLSTM and one
     sLSTM layer) and whisper-large-v3 (4 + 4 layers), each at full width
     in bf16 (remat none) with DTensor state beside its plain twin from
     the same state: (a) three AdamW steps, losses, grad norms and
     olmoe's MoE auxiliaries within phase 11's tolerances, each kernel's
     launches per DTensor step one forward and one backward a layer of
     its mixer (flash, the scan and the mLSTM kernels on each rank's
     shard through ``local_map``); (b) a prefill and 16 greedy tokens with
     a DTensor cache, tokens equal but on near-ties and every cache leaf
     in ``cache_specs``' placements; (c) each step's wall and own peak
     beside the plain step's; (d) in CPU subprocesses started with the
     phase, one traced cell per family on a fake 256-rank group.
 25. attention whose heads do not divide a 16-wide model axis, split over
     its keys (kvseq) and over its query rows (qseq): smollm-135m's
     training shape, yi-34b's width, whisper-large-v3's encoder (uneven
     shards) and its cross-attention, and a 100-token smollm prompt that
     leaves the last rank no rows or keys, full width in bf16, each rank's
     work run in turn on the card through the functions the mesh path
     calls (``fallback_pieces``): output, log-sum-exp and gradients
     against the one-call kernels and the plain version, one forward and
     one backward launch per rank that holds rows and keys (16 + 16 per
     split call, 15 + 15 for the prompt), the pieces' summed time beside
     the one call's.

The kernels line's ``launches`` add up each kernel's launches over the
main paths that run it (flash: phases 8, 13, 16, 17, 23, 24 and 25; the scan
and the mLSTM kernels: phases 10, 13 and 24; ``score_cov``:
phases 3, 19, 20c, 21 and 22; ``var_downdate``: phases 3, 20c, 21 and 22;
``masked_kernel`` and ``fit_grad``: phase 3;
``tpe_scores``: phases 4, 20c, 21 and 22).

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that line.  Without a CUDA device it exits 2 and prints no result.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import ctypes
import functools
import json
import math
import multiprocessing
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import AsyncTuner, StudyBank, Tuner  # noqa: E402
from repro_torch.core import gp as gp_lib  # noqa: E402
from repro_torch.core import scoring  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa
from repro_torch.kernels.gp_acquisition import ops, ref  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ref as mlstm_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as ssm_ref  # noqa: E402
from repro_torch.kernels.tpe_kde import ops as tpe_ops  # noqa: E402
from repro_torch.kernels.tpe_kde import ref as tpe_ref  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.roofline import H100  # noqa: E402
from repro_torch.models import (Runtime, forward_decode,  # noqa: E402
                                forward_prefill, init_params)
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.transformer import layer_specs  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.scheduler import (FaultInjection,  # noqa: E402
                                   ProcessScheduler, SerialScheduler,
                                   TaskQueueScheduler)
from repro_torch.service import (ServiceClient, TuningService,  # noqa
                                 chaos)
from repro_torch.service import serve as serve_service  # noqa: E402
from repro_torch.train.step import (TrainHyper,  # noqa: E402
                                    init_train_state, make_decode_step,
                                    make_prefill_step, make_train_step)
from repro_torch.tree import tree_items, tree_map  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3,
# and the special-function units (16 exponentials per clock per SM, CUDA
# programming guide's arithmetic-instruction throughput table for compute
# capability 9.0) at the 1,980 MHz maximum boost clock on 132 SMs; the
# dense bf16 rate and the HBM rate are the launch layer's card record
PEAK_FP32 = 67e12
PEAK_BF16 = H100.peak_flops   # dense bf16 tensor-core rate
PEAK_TF32 = 495e12   # dense TF32 tensor-core rate
# the mLSTM kernels and score_cov's product K L^-T run each fp32 product as
# three TF32 products (split TF32), so those operations go at a third of
# the TF32 rate
PEAK_SPLIT_TF32 = PEAK_TF32 / 3
PEAK_BYTES = H100.hbm_bw
SM_CLOCK_HZ = 1.98e9
PEAK_EXP = 16 * 132 * SM_CLOCK_HZ
# fp32 operations around each exponential of the TPE kernels: difference,
# square, scale, and one multiply-add per density (two for tpe_scores)
TPE_FLOPS_PER_EXP = {"tpe_scores": 7, "parzen_logdens": 5}

FLEET = dict(B=64, n_obs=200, batch=4, rounds=3)
NEAR_TIE = 1e-4
EPS32 = float(np.finfo(np.float32).eps)


# --------------------------------------------------------------------------- #
# objectives and spaces (numpy, seeded)
# --------------------------------------------------------------------------- #
_H6_A = np.array([[10, 3, 17, 3.5, 1.7, 8], [0.05, 10, 17, 0.1, 8, 14],
                  [3, 3.5, 1.7, 10, 17, 8], [17, 8, 0.05, 10, 0.1, 14]])
_H6_P = 1e-4 * np.array([[1312, 1696, 5569, 124, 8283, 5886],
                         [2329, 4135, 8307, 3736, 1004, 9991],
                         [2348, 1451, 3522, 2883, 3047, 6650],
                         [4047, 8828, 8732, 5743, 1091, 381]])
_H6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])


def neg_hartmann6(p: dict) -> float:
    """-Hartmann-6 on [0, 1]^6 (maximum 3.32237)."""
    x = np.array([p[f"x{i}"] for i in range(6)])
    inner = np.sum(_H6_A * (x[None, :] - _H6_P) ** 2, axis=1)
    return float(np.sum(_H6_ALPHA * np.exp(-inner)))


def hartmann_space():
    from scipy.stats import uniform
    return {f"x{i}": uniform(0, 1) for i in range(6)}


def branin(x1: float, x2: float) -> float:
    a, b, c = 1.0, 5.1 / (4 * math.pi ** 2), 5 / math.pi
    r, s, t = 6.0, 10.0, 1 / (8 * math.pi)
    return (a * (x2 - b * x1 ** 2 + c * x1 - r) ** 2
            + s * (1 - t) * math.cos(x1) + s)


def modified_branin(p: dict) -> float:
    """Mixed Branin of the paper's Fig. 3: continuous x1, 16-level x2, and a
    categorical shelf."""
    shelf = {"low": 0.0, "high": 12.0}[p["mode"]]
    return branin(p["x1"], float(p["x2"])) + shelf


def branin_space():
    from scipy.stats import uniform
    return {"x1": uniform(-5, 15), "x2": range(0, 16),
            "mode": ["low", "high"]}


# --------------------------------------------------------------------------- #
# float64 GP-BUCB oracle (numpy), the judge of near-ties
# --------------------------------------------------------------------------- #
def _matern_np(A, B, var):
    d2 = ((A * A).sum(-1)[:, None] + (B * B).sum(-1)[None, :]
          - 2.0 * A @ B.T)
    s = math.sqrt(5.0) * np.sqrt(np.maximum(d2, 1e-12))
    return var * (1.0 + s + (5.0 / 3.0) * d2) * np.exp(-s)


def bucb_acquisition(X, z, C, ls, var, noise, prev, domain_size,
                     pending=None):
    """UCB surface of GP-BUCB slot ``len(prev)``, in float64: the posterior
    of observations X (n, d) with standardized values z, extended by the
    in-flight rows ``pending`` (m, d) and the already-picked candidates
    ``C[prev]``, all hallucinated at their mean, at every candidate of
    C (S, d).  ls (d,), var and noise are the fitted hyperparameters (noise
    including its floor)."""
    X, C = np.asarray(X, np.float64), np.asarray(C, np.float64)
    P = np.zeros((0, X.shape[1])) if pending is None else \
        np.asarray(pending, np.float64)
    ls = np.asarray(ls, np.float64)
    var, noise = float(var), float(noise)
    Xs, Cs = X / ls, C / ls
    diag = var + noise + 1e-6 * max(var, 1.0)
    K = _matern_np(Xs, Xs, var)
    np.fill_diagonal(K, diag)
    mu = _matern_np(Cs, Xs, var) @ np.linalg.solve(K, np.asarray(z, float))
    Xe = np.concatenate([Xs, P / ls, Cs[list(prev)]], 0)
    Ke = _matern_np(Xe, Xe, var)
    np.fill_diagonal(Ke, diag)
    kc = _matern_np(Cs, Xe, var)
    sig2 = var + noise - np.sum(kc * np.linalg.solve(Ke, kc.T).T, 1)
    t = max(len(Xe), 1)
    beta = float(np.clip(2.0 * math.log(max(domain_size, 2.0) * t * t
                                        * math.pi ** 2 / 0.6), 1.0, 100.0))
    return mu + math.sqrt(beta) * np.sqrt(np.maximum(sig2, 1e-10))


def picks_agree(pa, pb, oracle, tol=NEAR_TIE):
    """Two pick sequences agree slot by slot until the first slot where they
    differ; there both picks must be within ``tol`` (relative) of the
    oracle's best acquisition value at that slot, a near-tie after which
    the sequences may part.  ``oracle(prev)`` returns the slot's surface.
    Returns (agree, first_differing_slot or None)."""
    for s, (a, b) in enumerate(zip(pa, pb)):
        if a == b:
            continue
        acq = oracle(list(pa[:s]))
        top = float(np.max(acq))
        gap = max(top - acq[a], top - acq[b])
        return gap <= tol * max(abs(top), 1e-12), s
    return True, None


def tpe_score64(X, y, C, gamma, pending=None):
    """TPE l(x)/g(x) log-ratio of every candidate C (S, d), in float64: the
    split of observations X (n, d) by the signed values y (good = the
    ceil(gamma n) best, computed in float32 as the port does), per-dim
    bandwidths (Scott base times the clipped per-dim spread of each
    split), the in-flight rows ``pending`` (m, d) joining the bad split,
    and the good rows standing in for an empty bad split."""
    X = np.asarray(X, np.float64)
    C = np.asarray(C, np.float64)
    n, d = X.shape
    n_good = max(1, int(np.ceil(np.float32(gamma) * np.float32(n))))
    order = np.argsort(-np.asarray(y, np.float64), kind="stable")
    good, bad = X[order[:n_good]], X[order[n_good:]]
    P = (np.zeros((0, d)) if pending is None
         else np.asarray(pending, np.float64).reshape(-1, d))
    bad_eff = bad if len(bad) else good
    b_pts = np.concatenate([bad_eff, P])

    def bw(pts):
        base = max(len(pts) ** (-1.0 / (d + 4)), 1e-2) * 0.5 + 1e-3
        return base * np.clip(2.0 * pts.std(axis=0), 0.1, 1.0)

    def kde_sum(pts, h):
        out = np.zeros((len(C), d))
        for s0 in range(0, len(C), 2048):
            d2 = (C[s0:s0 + 2048, None, :] - pts[None, :, :]) ** 2
            out[s0:s0 + 2048] = np.exp(-d2 * (0.5 / (h * h))).sum(axis=1)
        return out

    bw_g, bw_b = bw(good), bw(b_pts)
    lg = np.log(kde_sum(good, bw_g) / len(good) + 1e-12).sum(axis=1)
    bad_sum = kde_sum(bad, bw_b) if len(bad) else kde_sum(good, bw_g)
    if len(P):
        bad_sum = bad_sum + kde_sum(P, bw_b)
    lb = np.log(bad_sum / len(b_pts) + 1e-12).sum(axis=1)
    return lg - lb


def top_b_oracle(score):
    """``picks_agree`` oracle of a top-b selection: the slot's surface is
    the score with the picks before it removed."""
    def oracle(prev):
        acq = np.array(score, np.float64)
        acq[list(prev)] = -np.inf
        return acq
    return oracle


# the clustering pick's near-ties, judged by its float64 replay: at the
# top-set boundary and at a cluster's pick, the acquisition gap over the
# surface's largest magnitude (NEAR_TIE, the GP pick's margin); at a
# seeding choice, the draw's distance to the nearest cumulative-weight
# edge over the total (1e-5: the replay sums the weights, rounded to
# float32 as both devices hold them, in float64, so an edge moves only by
# the float32 summation of the device that drew: the CPU's cumulative sum
# accumulates in double and rounds each edge once, the card's scan in
# float32 moves an edge by ~log2(n_top) 2^-24 = 7e-7 of the total at
# n_top = 3,360; the rest of the margin is for weights that differ in their
# last float32 bits); at a Lloyd or final assignment, a point's two
# nearest centers' squared distances, their gap over the larger (1e-5:
# ~100 float32 ulps of the distance, the centers being float32 weighted
# means)
CLUSTER_TIES = {"top": NEAR_TIE, "seed": 1e-5, "assign": 1e-5,
                "pick": NEAR_TIE}


def cluster_replay(acq, C, n, n_top, u, iters=10):
    """The clustering pick of one study in float64 (``gp.bank_cluster_pick``
    on the surface ``acq`` (S,), the raw candidate rows C (S, d), the
    k-means uniforms u (n,)): returns (picks, the smallest margin of each
    kind of decision, keyed as ``CLUSTER_TIES``)."""
    acq = np.asarray(acq, np.float64)
    C = np.asarray(C, np.float64)
    S = len(acq)
    scale = max(float(np.abs(acq).max()), 1e-12)
    order = np.argsort(-acq, kind="stable")
    top = order[:n_top]
    m = {k: np.inf for k in CLUSTER_TIES}
    if n_top < S:
        m["top"] = (acq[top[-1]] - acq[order[n_top]]) / scale
    tv = acq[top]
    w = tv - tv[-1] + 1e-6
    X = C[top]

    def choice(p, ui):
        # the float32 weights both devices draw from, summed in float64
        cum = np.cumsum(np.asarray(p, np.float32).astype(np.float64))
        r = cum[-1] * (1.0 - float(ui))
        i = min(int(np.searchsorted(cum, r, side="left")), len(p) - 1)
        lo = cum[i - 1] if i else 0.0
        m["seed"] = min(m["seed"], min(r - lo, cum[i] - r) / cum[-1])
        return i

    def assign(centers):
        d2 = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
        two = np.sort(d2, axis=1)[:, :2]
        gap = (two[:, 1] - two[:, 0]) / np.maximum(two[:, 1], 1e-300)
        m["assign"] = min(m["assign"], float(gap.min()))
        return np.argmin(d2, axis=1)

    centers = np.zeros((n, C.shape[1]))
    centers[0] = X[choice(w / max(w.sum(), 1e-9), u[0])]
    d2min = ((X - centers[0]) ** 2).sum(-1)
    for i in range(1, n):
        probs = d2min * w
        tot = probs.sum()
        probs = probs / tot if tot > 0 else np.full(len(w), 1.0 / len(w))
        c = X[choice(probs, u[i])]
        centers[i] = c
        d2min = np.minimum(d2min, ((X - c) ** 2).sum(-1))
    for _ in range(iters):
        a = assign(centers)
        for c in range(n):
            wc = w[a == c]
            if wc.sum() > 0:
                centers[c] = (wc[:, None] * X[a == c]).sum(0) / wc.sum()
    a = assign(centers)
    picked = np.zeros(n_top, bool)
    picks = []
    for c in range(n):
        sel = (a == c) & ~picked
        if not sel.any():
            sel = ~picked
        vals = np.where(sel, tv, -np.inf)
        j = int(np.argmax(vals))
        if sel.sum() > 1:
            two = np.sort(vals)[-2:]
            m["pick"] = min(m["pick"], (two[1] - two[0]) / scale)
        picked[j] = True
        picks.append(int(top[j]))
    return picks, m


# the clustering head alone on one float32 surface, card vs CPU: only the
# order of float32 sums differs (the seeding's cumulative weights, the
# centers' weighted sums, the distances' six-term sums), so only margins of
# that order excuse a difference: 1e-5 of the cumulative total at a
# seeding choice (two orders of a 3,360-term float32 scan part by
# ~sqrt(n) 2^-24 = 3.5e-6), 1e-5 relative at an assignment; the top set
# and the picks compare equal float32 values on both devices (-1: never)
HEAD_TIES = {"top": -1.0, "seed": 1e-5, "assign": 1e-5, "pick": -1.0}


def cluster_near_tie(margins, ties=CLUSTER_TIES) -> bool:
    """Whether a replay's margins show a near-tie that may part two pick
    sequences (``CLUSTER_TIES``, or ``HEAD_TIES``)."""
    return any(margins[k] <= tol for k, tol in ties.items())


# --------------------------------------------------------------------------- #
# helpers
# --------------------------------------------------------------------------- #
def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: " + out.stderr.strip()


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gp_system(B, S, na, n_act, d, seed, dev, noise=(1e-3, 1e-2)):
    """A fitted-looking GP system per study at the bank's shapes: prescaled
    candidates and observations, masked tail past ``n_act``, noise drawn
    uniformly from the range ``noise``, factors from the port's own
    stages."""
    rng = np.random.default_rng(seed)
    dp = max(8, -(-d // 8) * 8)
    X = rng.uniform(size=(B, na, d)).astype(np.float32)
    C = rng.uniform(size=(B, S, d)).astype(np.float32)
    mask = np.zeros((B, na), np.float32)
    mask[:, :n_act] = 1.0
    X *= mask[..., None]
    ls = rng.uniform(0.2, 0.8, size=(B, d)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=B).astype(np.float32)
    noise = rng.uniform(*noise, size=B).astype(np.float32)
    y = (rng.normal(size=(B, na)) * mask).astype(np.float32)
    t = {k: torch.as_tensor(v, device=dev) for k, v in dict(
        X=X, C=C, mask=mask, ls=ls, var=var, noise=noise, y=y).items()}
    L, Linv, _ = gp_lib.bank_factors(t["X"], t["mask"], t["ls"], t["var"],
                                     t["noise"])
    Xs = gp_lib.bank_prescale_X(t["X"], t["ls"])
    Cs = gp_lib.bank_prescale_C(t["C"], t["ls"])
    alpha = scoring.kinv_matvec(Linv, t["y"] * t["mask"])
    assert Cs.shape[-1] == dp
    return dict(Cs=Cs, Xs=Xs, mask=t["mask"], L=L, Linv=Linv, alpha=alpha,
                var=t["var"], noise=t["noise"], n_act=n_act)


def _max_err(a, b) -> float:
    return float((a - b).abs().max())


def kernel_errors(B, S, na, n_act, d, dev, seed=7):
    """Every kernel output against its plain version on the same inputs at
    one shape.  Returns ``({output: (max_abs_err, tolerance)}, inputs)``.

    Tolerances.  K and k(C, x*): both sum the squared differences in
    column order, the kernel with one FMA a column, so d2 differs by a few
    ulps of d2 <= 2 (|c|^2 + |x|^2), which moves K by at most (5/6) var per
    unit of d2: within 8 eps32 (|c|^2 + |x|^2)_max var_max.  mu: a sum over na, 1e-5 of the
    sum of absolute terms.  sig2: subtracts a sum of squares of K L^-T,
    whose terms grow with the factor's condition: 1e-4 of the prior
    variance, the JAX package's own kernel-test tolerance."""
    assert n_act < na, "the downdate's slot n_act must be a free row"
    g = gp_system(B, S, na, n_act, d, seed=seed, dev=dev)
    Cs, Xs, mask, Linv, alpha = (g["Cs"], g["Xs"], g["mask"], g["Linv"],
                                 g["alpha"])
    var, noise = g["var"], g["noise"]
    mu_k, sig2_k, K_k = ops.score_cov(Cs, Xs, mask, Linv, alpha, var, noise)
    mu_r, sig2_r, K_r = ref.score_cov_ref(Cs, Xs, mask, Linv, alpha, var,
                                          noise)
    c2x2 = float((Cs * Cs).sum(-1).max() + (Xs * Xs).sum(-1).max())
    tol_k = 8 * EPS32 * c2x2 * float(var.max())
    scale_mu = float((K_r.abs() @ alpha.abs()[..., None]).max())
    scale_s2 = float((var + noise).max())
    errs = {"K": (_max_err(K_k, K_r), tol_k),
            "mu": (_max_err(mu_k, mu_r), 1e-5 * scale_mu),
            "sig2": (_max_err(sig2_k, sig2_r), 1e-4 * scale_s2)}
    # one GP-BUCB slot: pick, append, downdate (kernel vs plain on the same
    # inputs, each on its own copy of the cached block)
    rows = torch.arange(B, device=dev)
    idx = torch.argmax(mu_r + 2.0 * torch.sqrt(sig2_r), dim=1)
    slot = torch.full((B,), n_act, dtype=torch.int32, device=dev)
    _, _, u, schur = scoring.factor_append(
        g["L"].clone(), Linv.clone(), slot.long(), K_r[rows, idx], var, noise)
    x_star = Cs[rows, idx].contiguous()
    Kc_k, Kc_r = K_r.clone(), K_r.clone()
    s2d_k, kn_k = ops.var_downdate(Cs, x_star, Kc_k, u, schur, sig2_r, var,
                                   slot=slot)
    s2d_r, kn_r = ref.var_downdate_ref(Cs, x_star, Kc_r, u, schur, sig2_r,
                                       var)
    col = Kc_k[rows, :, slot.long()]
    errs.update({
        "sig2_dd": (_max_err(s2d_k, s2d_r), 1e-4 * scale_s2),
        "knew": (_max_err(kn_k, kn_r), tol_k),
        "Kc_col": (_max_err(col, kn_r), tol_k)})
    inputs = dict(Cs=Cs, Xs=Xs, mask=mask, Linv=Linv, alpha=alpha, var=var,
                  noise=noise, x_star=x_star, u=u, schur=schur, sig2=sig2_r,
                  Kc=K_r, slot=slot)
    return errs, inputs


def time_kernels(t, reps: int):
    """Kernel and plain times, operations and bytes at one shape."""
    Cs, Xs, mask, Linv, alpha = t["Cs"], t["Xs"], t["mask"], t["Linv"], \
        t["alpha"]
    var, noise, Kc = t["var"], t["noise"], t["Kc"]
    B, S, dp = Cs.shape
    na = Xs.shape[1]
    recs = {}
    ms = cuda_ms(lambda: ops.score_cov(Cs, Xs, mask, Linv, alpha, var,
                                       noise), reps)
    plain = cuda_ms(lambda: ref.score_cov_ref(Cs, Xs, mask, Linv, alpha,
                                              var, noise), reps)
    # operations: the triangular product (2 flops per multiply-add over the
    # lower triangle), on the tensor cores in split TF32, and the distances
    # (a difference and an FMA per column) and mu in fp32
    tri = B * S * na * (na + 1)
    rest = B * S * na * (3 * dp + 2)
    recs["score_cov"] = dict(
        ms=ms, plain_ms=plain, flops=tri + rest,
        t_ops=tri / PEAK_SPLIT_TF32 + rest / PEAK_FP32,
        t_ops_fp32=(tri + rest) / PEAK_FP32,
        bytes=4 * (B * S * dp + B * na * dp + 2 * B * na + B * na * na
                   + 2 * B + 2 * B * S + B * S * na))
    dd = (Cs, t["x_star"], Kc.clone(), t["u"], t["schur"], t["sig2"], var)
    ms = cuda_ms(lambda: ops.var_downdate(*dd, slot=t["slot"]), reps)
    plain = cuda_ms(lambda: ref.var_downdate_ref(*dd), reps)
    recs["var_downdate"] = dict(
        ms=ms, plain_ms=plain, flops=2 * B * S * na + 3 * B * S * dp,
        bytes=4 * (B * S * na + B * S * dp + B * dp + B * na + 4 * B
                   + 4 * B * S))
    for r in recs.values():
        t_ops = r.get("t_ops", r["flops"] / PEAK_FP32)
        t_bytes = r["bytes"] / PEAK_BYTES
        r.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
    return recs


# (tag, B, S, na, n_act, d): the fleet shape (K resident in shared memory),
# one study at phase 21's shape and at a small S (the persistent grid at
# B = 1: one CTA per row block, most SMs idle), and one shape for every
# other branch of score_cov: na 16 and 32 (one
# k-slab, zero columns past na) with a ragged S, na 512 and 1024 (K
# streamed from global memory) and dp 64 at na 256 (streamed: the
# candidates take the room K would need)
GP_KERNEL_SHAPES = [("fleet", FLEET["B"], 16800, 256, 212, 6),
                    ("single", 1, 16800, 256, 207, 6),
                    ("single-small", 1, 300, 64, 23, 2),
                    ("ragged", 3, 1000, 16, 11, 19),
                    ("na32-ragged", 2, 517, 32, 29, 6),
                    ("na512", 2, 700, 512, 400, 6),
                    ("streamed", 4, 3000, 1024, 1000, 6),
                    ("dp64", 2, 300, 256, 200, 60)]


def check_kernels(dev, reps_main: int):
    """Phase 2: every kernel against its plain version on the card at
    ``GP_KERNEL_SHAPES``, score_cov run twice at the fleet shape and held
    bitwise equal, and its branch-free square root held equal to sqrtf on
    every float from 1e-12 up.  Returns the per-kernel records (errors over
    all shapes, times at the fleet shapes)."""
    bad = ops.sqrt_mismatches()
    log(f"[kernels] score_cov square root vs sqrtf on every float in "
        f"[1e-12, FLT_MAX]: {bad} mismatches")
    if bad:
        raise AssertionError("score_cov's square root differs from sqrtf")
    lib = ops.library()
    worst = {"score_cov": 0.0, "var_downdate": 0.0}
    recs = None
    for tag, B, S, na, n_act, d in GP_KERNEL_SHAPES:
        errs, inputs = kernel_errors(B, S, na, n_act, d, dev)
        torch.cuda.synchronize()
        dp = inputs["Cs"].shape[-1]
        regime = ("resident" if lib.gp_score_cov_smem_bytes(na, dp) > 0
                  else "streamed")
        log(f"[kernels] {tag}: score_cov keeps K {regime}")
        for name, (err, tol) in errs.items():
            ok = err <= tol
            log(f"[kernels] {tag} B={B} S={S} na={na} "
                f"dp={inputs['Cs'].shape[-1]} {name}: max_abs_err={err:.3e} "
                f"tol={tol:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag} {name} outside tolerance")
            kern = ("score_cov" if name in ("K", "mu", "sig2")
                    else "var_downdate")
            worst[kern] = max(worst[kern], err)
        if tag == "fleet":
            args = [inputs[k] for k in ("Cs", "Xs", "mask", "Linv", "alpha",
                                        "var", "noise")]
            check_deterministic("score_cov fleet shape (mu, sig2, K)",
                                lambda: ops.score_cov(*args), "kernels")
            recs = time_kernels(inputs, reps_main)
        if tag.startswith("single"):
            for name, r in time_kernels(inputs, reps_main).items():
                log(f"[kernels] {name} at B = 1 ({tag}, S={S} na={na}): "
                    f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
                    f"ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
        del inputs
    for name, r in recs.items():
        r["max_abs_err"] = worst[name]
        log(f"[kernels] {name} fleet shape: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {r['flops'] / 1e9:.2f} GFLOP, "
            f"{r['bytes'] / 1e9:.3f} GB; no single PyTorch call computes "
            "this function (library_ms null)")
        if "t_ops_fp32" in r:
            log(f"[kernels] {name} bound with every operation at the fp32 "
                f"rate (the FMA kernel's figure): "
                f"{max(r['t_ops_fp32'], r['bytes'] / PEAK_BYTES) * 1e3:.4f}"
                f" ms; kernel at {r['bound_ms'] / r['ms']:.1%} of the split-"
                "TF32 bound")
    return recs


# --------------------------------------------------------------------------- #
# the fit's kernels (phase 2)
# --------------------------------------------------------------------------- #
# (tag, B, na, n_act, d): the fleet cells' shape (16 studies at bucket 1024,
# six dimensions), ragged tiles with dp 24, one tile with nothing masked,
# and dp 104, whose tiles take more than 48 KB of shared memory
FIT_KERNEL_SHAPES = [("cells", 16, 1024, 1000, 6), ("ragged", 3, 100, 77, 19),
                     ("one-tile", 2, 64, 64, 2), ("wide", 2, 128, 100, 100)]
FIT_GRAD_ARGS = ("X", "mask", "Kinv", "alpha", "ls", "var", "noise_exp",
                 "n_eff")


def fit_system(B, na, n_act, d, dev, seed=5):
    """One closed-form fit step's inputs per study: rows with a ragged
    tail (``n_act - 8 b`` observed in study b), warm-ish hyperparameters,
    K^-1 from the factor's inverse and alpha = K^-1 z, as
    ``gp._nll_grad`` forms them."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(B, na, d))
    mask = np.zeros((B, na))
    for b in range(B):
        mask[b, :max(1, n_act - 8 * b)] = 1.0
    X *= mask[..., None]
    z = (np.sin(6 * X[..., 0]) + X[..., 1] + 0.05 * rng.normal(size=(B, na)))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=dev)
    X, mask, z = t(X), t(mask), t(z * mask)
    ls = t(rng.uniform(0.2, 0.8, (B, d)))
    var = t(rng.uniform(0.5, 2.0, B))
    noise_exp = t(rng.uniform(1e-3, 2e-2, B))
    L = gp_lib.cholesky_masked(X, mask, ls, var, noise_exp + 1e-5)
    Linv = scoring.linv_from_chol(L)
    return dict(X=X, mask=mask, ls=ls, var=var, noise_exp=noise_exp,
                Kinv=Linv.mT @ Linv, alpha=scoring.kinv_matvec(Linv, z),
                n_eff=torch.clamp(mask.sum(-1), min=1.0))


def fit_kernel_errors(B, na, n_act, d, dev, seed=5):
    """The fit's two kernels against their plain versions at one shape.
    Returns ``({output: (error, tolerance)}, inputs)``.

    ``masked_kernel``: the diagonal and the masked entries exactly; the
    Matern within 8 eps32 (|x|^2 + |y|^2)_max var_max (both sum the
    squared differences in column order, the kernel with one FMA a column,
    so d2 differs by a few ulps of d2, which moves K by at most (5/6) var
    per unit).  ``fit_grad``: against the
    plain version in float64 on the same float32 inputs, as a share of each
    component's sum of absolute terms (from |K^-1| + |alpha| |alpha|^T, the
    magnitudes W is rounded against), within 1e-5: the kernel rounds each
    pair's term in float32 (d2, sqrt, exp, W) and sums in float64."""
    g = fit_system(B, na, n_act, d, dev, seed)
    X, mask, ls, var = g["X"], g["mask"], g["ls"], g["var"]
    noise, jit = g["noise_exp"] + 1e-5, scoring.jitter(var)
    K_k = ops.masked_kernel(X, mask, ls, var, noise, jit)
    K_r = ref.masked_kernel(X, mask, ls, var, noise, jit)
    eye = torch.eye(na, dtype=torch.bool, device=dev)
    off = (mask[:, :, None] * mask[:, None, :] > 0) & ~eye
    x2 = float(((X / ls[:, None, :]) ** 2).sum(-1).max())
    grad = ops.fit_grad(*(g[k] for k in FIT_GRAD_ARGS))
    a64 = [g[k].double() for k in FIT_GRAD_ARGS]
    want = ref.fit_grad_ref(*a64)
    Kinv, alpha = a64[2], a64[3]
    a64[2] = Kinv.abs() + alpha.abs()[:, :, None] * alpha.abs()[:, None, :]
    a64[3] = torch.zeros_like(alpha)
    scale = ref.fit_grad_ref(*a64).abs()
    errs = {"K": (_max_err(K_k, K_r), 8 * EPS32 * 2 * x2 * float(var.max())),
            "K_diag_masked": (_max_err(K_k[~off], K_r[~off]), 0.0),
            "grad": (float(((grad.double() - want).abs() / scale).max()),
                     1e-5)}
    return errs, g


def check_fit_kernels(dev, reps_main: int):
    """Phase 2: the fit's kernels against their plain versions at
    ``FIT_KERNEL_SHAPES``, each run twice at the cells' shape and held
    bitwise equal, and timed there.  Returns the per-kernel records."""
    worst = {"masked_kernel": 0.0, "fit_grad": 0.0}
    recs = {}
    for tag, B, na, n_act, d in FIT_KERNEL_SHAPES:
        errs, g = fit_kernel_errors(B, na, n_act, d, dev)
        torch.cuda.synchronize()
        for name, (err, tol) in errs.items():
            ok = err <= tol
            log(f"[fit-kernels] {tag} B={B} na={na} d={d} {name}: "
                f"err={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag} {name} outside tolerance")
        worst["masked_kernel"] = max(worst["masked_kernel"], errs["K"][0])
        worst["fit_grad"] = max(worst["fit_grad"], errs["grad"][0])
        if tag != "cells":
            continue
        var = g["var"]
        kargs = (g["X"], g["mask"], g["ls"], var, g["noise_exp"] + 1e-5,
                 scoring.jitter(var))
        gargs = [g[k] for k in FIT_GRAD_ARGS]
        check_deterministic("masked_kernel cells' shape",
                            lambda: ops.masked_kernel(*kargs), "fit-kernels")
        check_deterministic("fit_grad cells' shape",
                            lambda: ops.fit_grad(*gargs), "fit-kernels")
        recs["masked_kernel"] = dict(
            ms=cuda_ms(lambda: ops.masked_kernel(*kargs), reps_main),
            plain_ms=cuda_ms(lambda: ref.masked_kernel(*kargs), reps_main),
            bytes=4 * (B * na * na + B * na * (d + 1) + B * (d + 3)))
        recs["fit_grad"] = dict(
            ms=cuda_ms(lambda: ops.fit_grad(*gargs), reps_main),
            plain_ms=cuda_ms(lambda: ref.fit_grad_ref(*gargs), reps_main),
            bytes=4 * (B * na * (na + 1) // 2 + B * na * (d + 2)
                       + B * (d + 4)))
    for name, r in recs.items():
        r.update(max_abs_err=worst[name],
                 bound_ms=r["bytes"] / PEAK_BYTES * 1e3, bound_by="bytes")
        log(f"[fit-kernels] {name} cells' shape: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"(bytes, {r['bytes'] / 1e6:.1f} MB), kernel at "
            f"{r['bound_ms'] / r['ms']:.1%} of it; no single PyTorch call "
            "computes this function (library_ms null)")
    return recs


# --------------------------------------------------------------------------- #
# TPE kernels (phase 2)
# --------------------------------------------------------------------------- #
TPE_TOL = 1e-4   # the JAX package's own kernel-vs-oracle tolerance


def tpe_system(B, S, na, n_live, d, dev, seed=11, kind="ask"):
    """Inputs of both TPE kernels at the bank's layout: candidates, live
    observation rows (study b keeps ``n_live - b % 3``; the rest of the
    bucket is zeros), a good and a bad split, and per-split per-dim scales
    that differ along the dims.  ``kind`` "ask": every live row carries a
    0/1 weight, as on the ask path; "holes": every ninth live row is masked
    out of both splits; "shared": the weights are fractional and the last
    good row is in the bad split too (at one live row, the empty-bad case).
    Returns the tensors of both kernels' calls on ``dev`` and each study's
    count of weighted rows."""
    rng = np.random.default_rng(seed)
    dp = max(8, -(-d // 8) * 8)
    live = np.array([max(1, n_live - b % 3) for b in range(B)], np.int32)
    row = np.arange(na)[None, :]
    keep = row < live[:, None]
    C = np.zeros((B, S, dp), np.float32)
    C[..., :d] = rng.uniform(size=(B, S, d))
    X = np.zeros((B, na, dp), np.float32)
    X[..., :d] = rng.uniform(size=(B, na, d)) * keep[..., None]
    n_good = np.maximum(1, live // 4)[:, None]
    on = keep & (row % 9 != 5) if kind == "holes" else keep
    wg = (on & (row < n_good)).astype(np.float32)
    wb = (on & (row >= n_good)).astype(np.float32)
    wb[wb.sum(1) == 0, 0] = 1.0          # a bad split is never empty
    if kind == "shared":
        frac = rng.uniform(0.25, 1.0, size=(B, na)).astype(np.float32)
        wb = np.maximum(wb, on & (row == n_good - 1)).astype(np.float32)
        wg, wb = wg * frac, wb * frac
    ag = rng.uniform(5.0, 50.0, size=(B, 1, d))
    ab = rng.uniform(5.0, 50.0, size=(B, 1, d))
    a = np.zeros((B, na, dp), np.float32)
    a[..., :d] = np.where(wg[..., None] > 0, ag, ab) * keep[..., None]
    scal = np.zeros((B, 4), np.float32)
    scal[:, 0] = 1.0 / wg.sum(1)
    scal[:, 1] = 1.0 / wb.sum(1)
    w = np.maximum(wg, wb)
    bw = tpe_ref.scott_bandwidth(torch.as_tensor(w.sum(1)), d).numpy()
    scal_p = np.zeros((B, 4), np.float32)
    scal_p[:, 0] = 0.5 / (bw * bw)
    scal_p[:, 1] = 1.0 / w.sum(1)
    t = {k: torch.as_tensor(v, device=dev) for k, v in dict(
        C=C, X=X, a=a, wg=wg, wb=wb, scal=scal, w=w, scal_p=scal_p,
        live=live).items()}
    return dict(tpe=(t["C"], t["X"], t["a"], t["wg"], t["wb"], t["scal"],
                     t["live"]),
                parzen=(t["C"], t["X"], t["w"], t["scal_p"], t["live"]),
                d=d, live=live, weighted=(w > 0).sum(1))


def tpe_kernel_errors(B, S, na, n_live, d, dev, seed=11, kind="ask"):
    """Both TPE kernels against their plain versions on the same inputs at
    one shape.  Returns ``({kernel: (max_abs_err, tolerance)}, system)``.

    Tolerance 1e-4 absolute per score, the JAX package's own tolerance for
    these kernels: a score sums 2d (tpe) or d (parzen) logs of fp32 sums of
    positive terms, each of which the two versions add in another order
    (relative error of a few eps times the row count's square root), and
    both floor every density at 1e-12, so no log sees a cancelled sum."""
    g = tpe_system(B, S, na, n_live, d, dev, seed, kind)
    k = tpe_ops.tpe_scores(*g["tpe"], d_true=d)
    r = tpe_ref.tpe_scores_ref(*g["tpe"], d_true=d)
    kp = tpe_ops.parzen_logdens_bank(*g["parzen"], d_true=d)
    rp = tpe_ref.parzen_logdens_ref(*g["parzen"], d_true=d)
    assert bool(torch.isfinite(k).all()) and bool(torch.isfinite(kp).all())
    return {"tpe_scores": (_max_err(k, r), TPE_TOL),
            "parzen_logdens": (_max_err(kp, rp), TPE_TOL)}, g


def tpe_bound(name, S, weighted, d):
    """Least time for one call: the exponentials this call's data needs
    (one per candidate, dim and row that carries a weight in either split;
    ``weighted`` holds each study's count of such rows) over the
    special-function rate, the fp32 work around them over the fp32 rate,
    and the bytes the function must move (true candidate columns and
    weighted rows in, scores out) over the memory rate.  Returns (bound_ms,
    by, exp_ms, fp32_ms, bytes_ms, n_exp)."""
    rows = float(np.sum(weighted))
    n_exp = float(S) * rows * d
    words_per_row = 2 * d + 2 if name == "tpe_scores" else d + 1
    nbytes = 4 * (len(weighted) * S * d + rows * words_per_row
                  + len(weighted) * (4 + 1) + len(weighted) * S)
    t_exp = n_exp / PEAK_EXP
    t_fp32 = n_exp * TPE_FLOPS_PER_EXP[name] / PEAK_FP32
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(t_exp, t_fp32)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            t_exp * 1e3, t_fp32 * 1e3, t_bytes * 1e3, n_exp)


# (tag, B, S, na, n_live, d, kind of ``tpe_system``): the fleet path's
# shape, one study of it (the Tuner's ask), a ragged small shape with masked
# rows, a large bucket (sixteen row tiles per dimension) and fractional
# weights with a row in both splits
TPE_KERNEL_SHAPES = [("fleet", FLEET["B"], 16800, 256, 200, 6, "ask"),
                     ("one-study", 1, 16800, 256, 200, 6, "ask"),
                     ("ragged", 3, 257, 24, 17, 11, "holes"),
                     ("large-bucket", 4, 3000, 4096, 4000, 6, "ask"),
                     ("both-splits", 3, 300, 16, 3, 3, "shared")]


def check_tpe_kernels(dev, reps_main: int):
    """Phase 2, TPE suite: both kernels against their plain versions at
    ``TPE_KERNEL_SHAPES``, each shape run twice and required bitwise equal.
    Returns per-kernel records (worst error over all shapes; times and
    bound at the fleet shape)."""
    worst = {"tpe_scores": 0.0, "parzen_logdens": 0.0}
    recs = {}
    for tag, B, S, na, n_live, d, kind in TPE_KERNEL_SHAPES:
        errs, g = tpe_kernel_errors(B, S, na, n_live, d, dev, kind=kind)
        torch.cuda.synchronize()
        for name, (err, tol) in errs.items():
            ok = err <= tol
            log(f"[kernels] {tag} B={B} S={S} na={na} live<={n_live} "
                f"d={d} {name}: max_abs_err={err:.3e} tol={tol:.1e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag} {name} outside tolerance")
            worst[name] = max(worst[name], err)
        check_deterministic(
            f"tpe {tag} (tpe_scores, parzen_logdens)",
            lambda: (tpe_ops.tpe_scores(*g["tpe"], d_true=d),
                     tpe_ops.parzen_logdens_bank(*g["parzen"], d_true=d)),
            "kernels")
        reps = reps_main if tag == "fleet" else 5
        for name, args, kern, plain in (
                ("tpe_scores", g["tpe"], tpe_ops.tpe_scores,
                 tpe_ref.tpe_scores_ref),
                ("parzen_logdens", g["parzen"], tpe_ops.parzen_logdens_bank,
                 tpe_ref.parzen_logdens_ref)):
            ms = cuda_ms(lambda: kern(*args, d_true=d), reps)
            plain_ms = cuda_ms(lambda: plain(*args, d_true=d), 3, warmup=1)
            b_ms, by, e_ms, f_ms, y_ms, n_exp = tpe_bound(
                name, S, g["weighted"], d)
            log(f"[kernels] {tag} {name}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}): "
                f"{n_exp:.4g} exponentials over {int(g['weighted'].sum())} "
                f"weighted rows ({int(g['live'].sum())} live) -> "
                f"{e_ms:.4f} ms at 16/clk/SM x 132 SMs x "
                f"{SM_CLOCK_HZ / 1e9:.2f} GHz; fp32 bound {f_ms:.4f} ms; "
                f"bytes bound {y_ms:.4f} ms")
            if tag == "fleet":
                recs[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=by)
        del g
    for name, r in recs.items():
        r["max_abs_err"] = worst[name]
    log("[kernels] no single PyTorch call computes either TPE function "
        "(library_ms null)")
    return recs


# --------------------------------------------------------------------------- #
# flash attention (phase 2)
# --------------------------------------------------------------------------- #
# (tag, B, Sq, Sk, H, KV, hd, causal, dtype): the prefill shapes of the two
# served models, yi-34b's attention width, a ragged length and a
# cross-attention shape, each of the last two in fp32 (the FMA kernel) and
# bf16 (the tensor-core kernel), causal Sq < Sk at a reduced head size and
# MQA at hd 128 in bf16, and whisper-large-v3's encoder (1500 frames, 20
# heads of 64, non-causal) and decoder cross-attention (a 64-token prompt
# over the 1500 frames, phase 16's batch), and the prefills of phase 24:
# olmoe-1b-7b (16 heads of 128, MHA), jamba-v0.1-52b (32 over 8 heads of
# 128) and whisper-large-v3's decoder (a 64-token prompt), each causal
FLASH_SHAPES = [
    ("smollm-135m prefill", 8, 1024, 1024, 9, 3, 64, True, torch.bfloat16),
    ("phi3-mini-3.8b prefill", 4, 2048, 2048, 32, 32, 96, True,
     torch.bfloat16),
    ("yi-34b width", 1, 4096, 4096, 56, 8, 128, True, torch.bfloat16),
    ("ragged causal", 2, 1000, 1000, 9, 3, 64, True, torch.float32),
    ("cross, non-causal", 2, 77, 300, 4, 2, 32, False, torch.float32),
    ("ragged causal bf16", 2, 1000, 1000, 9, 3, 64, True, torch.bfloat16),
    ("cross, non-causal bf16", 2, 77, 300, 4, 2, 32, False, torch.bfloat16),
    ("rect causal hd 24 bf16", 2, 77, 300, 4, 2, 24, True, torch.bfloat16),
    ("mqa hd 128 bf16", 1, 300, 300, 8, 1, 128, True, torch.bfloat16),
    ("whisper-large-v3 encoder", 2, 1500, 1500, 20, 20, 64, False,
     torch.bfloat16),
    ("whisper-large-v3 cross", 8, 64, 1500, 20, 20, 64, False,
     torch.bfloat16),
    ("olmoe-1b-7b prefill", 4, 512, 512, 16, 16, 128, True, torch.bfloat16),
    ("jamba-v0.1-52b prefill", 2, 1024, 1024, 32, 8, 128, True,
     torch.bfloat16),
    ("whisper-large-v3 decoder prefill", 8, 64, 64, 20, 20, 64, True,
     torch.bfloat16),
]
FLASH_MAIN = "phi3-mini-3.8b prefill"   # the shape of the kernels line
# small shapes for the card test (tests/test_torch_models.py): GQA bf16,
# ragged at hd 96, MQA at hd 128, causal Sq < Sk at a reduced head size and
# a non-causal cross shape, each kind in fp32 and in bf16
FLASH_CARD_TEST_SHAPES = [
    ("bf16-gqa-hd64", 2, 256, 256, 9, 3, 64, True, torch.bfloat16),
    ("fp32-ragged-hd96", 1, 1000, 1000, 4, 4, 96, True, torch.float32),
    ("bf16-mqa-hd128", 1, 300, 300, 8, 1, 128, True, torch.bfloat16),
    ("fp32-rect-causal-hd24", 2, 77, 300, 4, 2, 24, True, torch.float32),
    ("bf16-ragged-hd96", 1, 1000, 1000, 4, 4, 96, True, torch.bfloat16),
    ("bf16-rect-causal-hd24", 2, 77, 300, 4, 2, 24, True, torch.bfloat16),
    ("fp32-cross-hd32", 2, 77, 300, 4, 2, 32, False, torch.float32),
    ("bf16-cross-hd32", 2, 77, 300, 4, 2, 32, False, torch.bfloat16),
    ("fp32-mqa-hd128", 1, 300, 300, 8, 1, 128, True, torch.float32),
]


def flash_inputs(shape, dev, seed=0):
    _, B, Sq, Sk, H, KV, hd, causal, dtype = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*size):
        return torch.randn(size, generator=g, device=dev).to(dtype)

    return randn(B, Sq, H, hd), randn(B, Sk, KV, hd), randn(B, Sk, KV, hd)


def flash_error(shape, dev, seed=0):
    """The kernel against its plain version on the same inputs at one shape.
    Returns (max_abs_err, tolerance, (q, k, v)).

    Tolerance.  fp32: 2e-5, the JAX package's own tolerance for this kernel;
    both versions compute in fp32 and differ only in the order of their
    sums and in where 1/sqrt(hd) is applied.  bf16: both round an fp32
    result to bf16, which differs by one bf16 ulp where the two fp32 values
    straddle a rounding boundary: 2^-7 of the largest output, plus the fp32
    tolerance."""
    q, k, v = flash_inputs(shape, dev, seed)
    causal = shape[7]
    got = flash_ops.sdpa(q, k, v, causal=causal)
    want = flash_ref.attention_ref(q, k, v, causal=causal)
    assert bool(torch.isfinite(got).all())
    err = _max_err(got.float(), want.float())
    tol = 2e-5
    if q.dtype == torch.bfloat16:
        tol += 2.0 ** -7 * float(want.float().abs().max())
    return err, tol, (q, k, v)


def flash_bound(shape):
    """Least time for one call: 4 B H hd flops per unmasked (q, k) pair
    (two products of hd multiply-adds) over the dense bf16 tensor-core rate
    (the fp32 rate for fp32 inputs), and q, k, v read once and the output
    written once over the memory rate.  Returns (bound_ms, by, flops,
    bytes)."""
    _, B, Sq, Sk, H, KV, hd, causal, dtype = shape
    if causal:
        rows = np.arange(Sq) + (Sk - Sq) + 1
        pairs = int(np.minimum(rows, Sk).sum())
    else:
        pairs = Sq * Sk
    flops = 4.0 * B * H * hd * pairs
    es = 2 if dtype == torch.bfloat16 else 4
    nbytes = es * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)
    t_ops = flops / (PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def library_sdpa(q, k, v, causal):
    """``scaled_dot_product_attention`` on the same inputs in its own
    (B, H, S, hd) layout, KV heads grouped by the call; a yardstick timed
    here only, never called by the port."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def check_deterministic(what, fn, prefix="flash"):
    """Two calls of ``fn`` on the same inputs give bitwise-equal tensors
    (the kernels use no atomics and a fixed order of sums)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        if x is not None and not torch.equal(x, y):
            raise AssertionError(f"{what}: two runs differ")
    log(f"[{prefix}] {what}: two runs bitwise equal")


def check_flash_kernel(dev, reps_main: int):
    """Phase 2, flash attention: the kernel against its plain version at
    the shapes of ``FLASH_SHAPES``, each timed beside the plain version,
    the library call and the bound, the bf16 kernel also run twice and
    held bitwise equal.  Returns the record of the kernels line (worst
    error over all shapes; times and bound at ``FLASH_MAIN``)."""
    rec = {"max_abs_err": 0.0}
    for shape in FLASH_SHAPES:
        tag, B, Sq, Sk, H, KV, hd, causal, dtype = shape
        err, tol, (q, k, v) = flash_error(shape, dev)
        torch.cuda.synchronize()
        ok = err <= tol
        desc = (f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} "
                f"{'causal' if causal else 'non-causal'} "
                f"{str(dtype).split('.')[-1]}")
        log(f"[flash] {tag} {desc}: max_abs_err={err:.3e} tol={tol:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash {tag} outside tolerance")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if dtype == torch.bfloat16:
            check_deterministic(
                f"flash {tag}",
                lambda: flash_ops.forward(q, k, v, causal, with_lse=True))
        ms = cuda_ms(lambda: flash_ops.sdpa(q, k, v, causal=causal),
                     reps_main)
        plain = cuda_ms(lambda: flash_ref.attention_ref(q, k, v,
                                                        causal=causal),
                        3, warmup=1)
        lib = cuda_ms(library_sdpa(q, k, v, causal), reps_main)
        b_ms, by, flops, nbytes = flash_bound(shape)
        log(f"[flash] {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"library {lib:.4f} ms, bound {b_ms:.4f} ms ({by}: "
            f"{flops / 1e9:.2f} GFLOP at "
            f"{'989 (bf16 tensor)' if dtype == torch.bfloat16 else '67 (fp32)'}"
            f" TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 TB/s); kernel at "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        if tag == FLASH_MAIN:
            rec.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                       bound_by=by)
        del q, k, v
    return rec


# --------------------------------------------------------------------------- #
# mLSTM chunk kernels, forward and backward (phase 2)
# --------------------------------------------------------------------------- #
# (tag, B, NH, S, dh, clamp): xlstm-1.3b's training shape (B 2, S 1024, 4
# heads of 1024), the reduced config's head size, a ragged length and a case
# whose strongly negative input gates make the clamp e^{-m} decide most
# denominators
MLSTM_SHAPES = [
    ("xlstm-1.3b train", 2, 4, 1024, 1024, False),
    ("reduced", 2, 2, 256, 64, False),
    ("ragged", 2, 4, 1000, 256, False),
    ("clamp", 2, 2, 512, 128, True),
]
MLSTM_MAIN = "xlstm-1.3b train"
# small shapes for the card test (tests/test_torch_xlstm.py)
MLSTM_CARD_TEST_SHAPES = [
    ("reduced-ragged", 1, 2, 200, 64, False),
    ("clamp-ragged", 1, 2, 130, 64, True),
    ("wide", 2, 1, 300, 256, False),
]
# max abs error of each output over the largest magnitude of the plain
# version's: both compute in fp32 and sum in other orders (64-token chunks
# and dh-long dot products; the gate gradients sum L^2 terms of mixed
# sign), measured at ~7e-6 of the largest magnitude on one H100
MLSTM_RTOL = 5e-5


def mlstm_inputs(shape, dev, seed=0):
    """q, k, v (B, NH, S, dh), logi, logf (B, NH, S) and an upstream
    gradient, made with numpy from ``seed``: unit queries and values, keys
    scaled by dh^-1/2 (by a tenth more in the clamp case), logf = log
    sigmoid(N(2, 1)) and logi N(0, 1) (N(-3, 1) in the clamp case)."""
    _, B, NH, S, dh, clamp = shape
    rng = np.random.default_rng(seed)

    def normal(*size):
        return rng.standard_normal(size, dtype=np.float32)

    q, v, g = normal(B, NH, S, dh), normal(B, NH, S, dh), normal(B, NH, S, dh)
    k = normal(B, NH, S, dh) * np.float32(dh ** -0.5 * (0.1 if clamp else 1))
    li = normal(B, NH, S) - np.float32(3.0 if clamp else 0.0)
    lf = -np.log1p(np.exp(-(normal(B, NH, S) + np.float32(2.0))))
    return [torch.as_tensor(a, device=dev) for a in (q, k, v, li, lf, g)]


MLSTM_GRADS = ("dq", "dk", "dv", "dlogi", "dlogf")


def mlstm_error(shape, dev, seed=0):
    """Both kernels against the plain version on the same inputs at one
    shape: the forward's h against ``ref.mlstm_chunkwise``, the backward's
    gradients against autograd of it.  Returns ({output: (max_abs_err,
    tolerance)}, inputs, h, gates)."""
    q, k, v, li, lf, g = mlstm_inputs(shape, dev, seed)
    h, gates = mlstm_ops.forward(q, k, v, li, lf)
    grads = mlstm_ops.backward(q, k, v, li, h, gates, g)
    xs = [t.clone().requires_grad_() for t in (q, k, v, li, lf)]
    want = mlstm_ref.mlstm_chunkwise(*xs)
    want_g = torch.autograd.grad(want, xs, g)
    want = want.detach()
    errs = {"h": (_max_err(h, want),
                  MLSTM_RTOL * float(want.abs().max()))}
    for name, got, ref_g in zip(MLSTM_GRADS, grads, want_g):
        assert bool(torch.isfinite(got).all()), name
        errs[name] = (_max_err(got, ref_g),
                      MLSTM_RTOL * float(ref_g.abs().max()))
    assert bool(torch.isfinite(h).all())
    return errs, (q, k, v, li, lf, g), h, gates


def mlstm_bound(shape):
    """Least time of each direction at one shape.  Operations: the products
    the chunkwise function needs, 2 flops per multiply-add: per chunk the
    causal (q, k) pairs twice (Q K^T and S V; four times in the backward:
    G V^T, dA K, dA^T Q, S^T G), the state update and q.C (2 L dh^2 each,
    skipped where the state is known zero: no update after the last
    chunk, no q.C in the first); the backward's dC recurrence, C G, dC V
    and K dC likewise.  The chunk-boundary states the backward needs are
    not counted (kept or recomputed, either costs more).  The kernels run
    each of these products as three TF32 tensor-core products, so the
    operations go at ``PEAK_SPLIT_TF32``.  Bytes: q, k, v, logi, logf in
    and h out (backward: q, k, v, logi, logf and dh in, dq, dk, dv, dlogi,
    dlogf out), once each.  Returns {direction: (bound_ms, by, flops,
    bytes)}."""
    _, B, NH, S, dh, _ = shape
    BH = B * NH
    pairs = inner = 0
    starts = list(range(0, S, 64))
    for c, t0 in enumerate(starts):
        L = min(64, S - t0)
        pairs += L * (L + 1) // 2
        inner += 2 * L * dh * dh * ((c < len(starts) - 1) + (c > 0))
    fwd = BH * (2 * 2 * pairs * dh + inner)
    bwd = BH * (4 * 2 * pairs * dh + 2 * inner)
    out = {}
    for name, flops, nbytes in (
            ("forward", fwd, 4 * BH * S * (4 * dh + 2)),
            ("backward", bwd, 4 * BH * S * (7 * dh + 4))):
        t_ops, t_bytes = flops / PEAK_SPLIT_TF32, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", flops,
                     nbytes)
    return out


def mlstm_workspace_bytes(shape):
    """Bytes of chunk-boundary states (BH x nC x dh^2 fp32 a set) that the
    kernels' decomposition moves through device memory: the forward writes
    C_c and reads it back (2 sets); the backward writes C_c and dC_{c+1}
    and reads each twice (6 sets)."""
    _, B, NH, S, dh, _ = shape
    states = 4 * B * NH * ((S + 63) // 64) * dh * dh
    return {"forward": 2 * states, "backward": 6 * states}


def log_mlstm_stages(q, k, v, li, lf, g, tag, reps: int = 10):
    """Device ms per call of each stage kernel of both directions, from
    torch.profiler's device rows over ``reps`` calls of each."""
    h, gates = mlstm_ops.forward(q, k, v, li, lf)
    calls = {"forward": lambda: mlstm_ops.forward(q, k, v, li, lf),
             "backward": lambda: mlstm_ops.backward(q, k, v, li, h, gates,
                                                    g)}
    for direction, fn in calls.items():
        _, _, prof = _profiled(lambda: [fn() for _ in range(reps)])
        rows = {}
        for e in _device_rows(prof.key_averages()):
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("::")[-1]
            rows[name] = rows.get(name, 0.0) + _device_ms(e) / reps
        log(f"[mlstm] {tag} {direction} stages (device ms per call): "
            + ", ".join(f"{name} {ms:.4f}" for name, ms in rows.items())
            + f"; sum {sum(rows.values()):.4f}")


def check_mlstm_kernels(dev, reps_main: int):
    """Phase 2, mLSTM: both kernels against the plain version at the four
    ``MLSTM_SHAPES``, each timed beside the plain version, the bound (the
    fp32 FMA rate's figure and the state workspace logged beside it; no
    single PyTorch call computes the function: library_ms null); at
    ``MLSTM_MAIN`` also the device time of each stage kernel and two runs
    of both kernels held bitwise equal.  Returns the records of the kernels
    line (worst error over all shapes; times and bounds at
    ``MLSTM_MAIN``)."""
    recs = {"mlstm_chunk": {"max_abs_err": 0.0},
            "mlstm_chunk_bwd": {"max_abs_err": 0.0}}
    for shape in MLSTM_SHAPES:
        tag, B, NH, S, dh, clamp = shape
        errs, (q, k, v, li, lf, g), h, gates = mlstm_error(shape, dev)
        torch.cuda.synchronize()
        share = mlstm_ref.clamp_share(q, k, li, lf)
        desc = f"B={B} NH={NH} S={S} dh={dh}"
        for name, (err, tol) in errs.items():
            ok = err <= tol
            log(f"[mlstm] {tag} {desc} {name}: max_abs_err={err:.3e} "
                f"tol={tol:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"mlstm {tag} {name} outside tolerance")
            kern = "mlstm_chunk" if name == "h" else "mlstm_chunk_bwd"
            recs[kern]["max_abs_err"] = max(recs[kern]["max_abs_err"], err)
        log(f"[mlstm] {tag}: the clamp e^-m decides {100 * share:.1f}% of "
            "the denominators")
        if clamp and share < 0.5:
            raise AssertionError("the clamp case does not exercise the clamp")
        reps = reps_main if tag == MLSTM_MAIN else 5
        if tag == MLSTM_MAIN:
            def both():
                h2, gates2 = mlstm_ops.forward(q, k, v, li, lf)
                return (h2, gates2,
                        *mlstm_ops.backward(q, k, v, li, h2, gates2, g))
            check_deterministic(f"mlstm {tag} outputs and gradients", both,
                                prefix="mlstm")
            log_mlstm_stages(q, k, v, li, lf, g, tag)
        xs = [t.clone().requires_grad_() for t in (q, k, v, li, lf)]
        graph = mlstm_ref.mlstm_chunkwise(*xs)
        times = {
            "forward": (
                cuda_ms(lambda: mlstm_ops.forward(q, k, v, li, lf), reps),
                cuda_ms(lambda: mlstm_ref.mlstm_chunkwise(q, k, v, li, lf),
                        3, warmup=1)),
            "backward": (
                cuda_ms(lambda: mlstm_ops.backward(q, k, v, li, h, gates, g),
                        reps),
                cuda_ms(lambda: torch.autograd.grad(graph, xs, g,
                                                    retain_graph=True),
                        3, warmup=1))}
        workspace = mlstm_workspace_bytes(shape)
        for (direction, (ms, plain)), (_, (b_ms, by, flops, nbytes)) in zip(
                times.items(), mlstm_bound(shape).items()):
            ws = workspace[direction]
            log(f"[mlstm] {tag} {direction}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound {b_ms:.4f} ms ({by}: "
                f"{flops / 1e9:.2f} GFLOP as three TF32 products each at "
                f"495/3 TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 TB/s); at "
                f"the fp32 FMA rate (67 TFLOP/s) "
                f"{flops / PEAK_FP32 * 1e3:.4f} ms; state workspace "
                f"{ws / 1e9:.3f} GB, with the products "
                f"{(flops / PEAK_SPLIT_TF32 + ws / PEAK_BYTES) * 1e3:.4f} "
                f"ms; kernel at {flops / ms / 1e9:.1f} TFLOP/s")
            if tag == MLSTM_MAIN:
                kern = ("mlstm_chunk" if direction == "forward"
                        else "mlstm_chunk_bwd")
                recs[kern].update(ms=ms, plain_ms=plain, library_ms=None,
                                  bound_ms=b_ms, bound_by=by)
        del q, k, v, li, lf, g, h, gates, xs, graph
    return recs


# --------------------------------------------------------------------------- #
# selective-scan kernels, forward and backward (phase 2)
# --------------------------------------------------------------------------- #
# (tag, B, S, di, N, inputs): jamba's training shape (one Mamba layer at
# B 1, S 2048, d_inner 8192, N 16), the reduced config's width, a ragged
# length with a d_inner whose 16 x 200 states fill no whole block, the
# kernel-test draw (Abar in [0.5, 0.999], as tests/test_kernels.py draws
# it) and an Abar near zero (the backward never divides by it).  "model"
# inputs are the discretisation the mixer makes: Abar = exp(delta A) with
# delta = softplus(N(-4.6, 1)) and A = -(1..N), Bx = delta x B.
SSM_SHAPES = [
    ("jamba train", 1, 2048, 8192, 16, "model"),
    ("reduced", 2, 256, 128, 8, "model"),
    ("ragged", 2, 1000, 200, 16, "model"),
    ("decay", 2, 512, 256, 16, "decay"),
    ("tiny Abar", 1, 300, 64, 16, "tiny"),
]
SSM_MAIN = "jamba train"
# small shapes for the card test (tests/test_torch_mamba.py)
SSM_CARD_TEST_SHAPES = [
    ("reduced-ragged", 2, 130, 128, 8, "model"),
    ("decay-n4", 1, 200, 40, 4, "decay"),
    ("tiny-n32", 1, 70, 16, 32, "tiny"),
]
# max abs error of each output over the largest magnitude of the plain
# version's: both walk the same recurrence in fp32, the kernel with fused
# multiply-adds and its own order of the sums over N (y) and over d_inner
# (dC); with Abar near 1 a rounding lives ~1/(1 - Abar) steps
SSM_RTOL = 5e-5
SSM_OUTPUTS = ("y", "h_S", "dAbar", "dBx", "dC")


def ssm_inputs(shape, dev, seed=0):
    """Abar, Bx (B, S, di, N), C (B, S, N), an upstream gradient dy (B, S,
    di) and dh_S (B, di, N), fp32, drawn on ``dev`` from ``seed``."""
    _, B, S, di, N, kind = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*size):
        return torch.randn(size, generator=g, device=dev)

    C, dy, dhS = randn(B, S, N), randn(B, S, di), randn(B, di, N)
    if kind == "model":
        delta = torch.nn.functional.softplus(randn(B, S, di) - 4.6)
        A = -torch.arange(1, N + 1, dtype=torch.float32, device=dev)
        Abar = torch.exp(delta[..., None] * A)
        Bx = (delta * randn(B, S, di))[..., None] * randn(B, S, 1, N)
    else:
        hi = 1e-3 if kind == "tiny" else 0.999
        lo = 0.0 if kind == "tiny" else 0.5
        Abar = lo + (hi - lo) * torch.rand((B, S, di, N), generator=g,
                                           device=dev)
        Bx = 0.1 * randn(B, S, di, N)
    return Abar, Bx, C, dy, dhS


def ssm_error(shape, dev, seed=0):
    """Both kernels against the plain versions on the same inputs at one
    shape: y and h_S against ``ref.ssm_scan_ref`` (the forward with h_S
    and the chunk states kept for the backward, and again without either,
    which must give the same y bit for bit), the gradients for dy and dh_S
    against ``ref.ssm_scan_bwd_ref``.  Returns ({output: (max_abs_err,
    tolerance)}, inputs, chunk states)."""
    A, X, C, dy, dhS = ssm_inputs(shape, dev, seed)
    y, hS, hck = ssm_ops.forward(A, X, C, return_state=True, keep=True)
    y2, no_state, no_chunks = ssm_ops.forward(A, X, C)
    if not torch.equal(y, y2) or no_state is not None or \
            no_chunks is not None:
        raise AssertionError("the forward kernel's y depends on writing "
                             "h_S and the chunk states")
    grads = ssm_ops.backward(A, X, C, hck, dy, dhS)
    want_y, want_h = ssm_ref.ssm_scan_ref(A, X, C, return_state=True)
    want = (want_y, want_h) + ssm_ref.ssm_scan_bwd_ref(A, X, C, dy, dhS)
    errs = {}
    for name, got, ref_t in zip(SSM_OUTPUTS, (y, hS) + grads, want):
        assert bool(torch.isfinite(got).all()), name
        errs[name] = (_max_err(got, ref_t),
                      SSM_RTOL * float(ref_t.abs().max()))
    return errs, (A, X, C, dy, dhS), hck


def ssm_bound(shape):
    """Least time of each direction at one shape, by bytes: Abar and Bx
    read once and y written once (with C) in the forward; Abar, Bx, C and
    dy read once and dAbar, dBx and dC written once in the backward.  The
    operations (2 flops per state element and step for the update and 2 for
    y; 6 in the backward) are far below the fp32 rate's share.  Returns
    {direction: (bound_ms, by, flops, bytes)}."""
    _, B, S, di, N, _ = shape
    big, c, y = B * S * di * N, B * S * N, B * S * di
    out = {}
    for name, flops, nbytes in (
            ("forward", 4 * big, 4 * (2 * big + c + y)),
            ("backward", 6 * big, 4 * (4 * big + 2 * c + y))):
        t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", flops,
                     nbytes)
    return out


def check_ssm_kernels(dev, reps_main: int):
    """Phase 2, selective scan: both kernels against the plain versions at
    the ``SSM_SHAPES``, each timed beside the plain version (the sequential
    recurrence, and autograd of it) and the bound (no single PyTorch call
    computes the scan: library_ms null).  Returns the records of the kernels
    line (worst error over all shapes; times and bound at ``SSM_MAIN``)."""
    recs = {"ssm_scan": {"max_abs_err": 0.0},
            "ssm_scan_bwd": {"max_abs_err": 0.0}}
    for shape in SSM_SHAPES:
        tag, B, S, di, N, kind = shape
        errs, (A, X, C, dy, dhS), hck = ssm_error(shape, dev)
        torch.cuda.synchronize()
        desc = f"B={B} S={S} di={di} N={N} ({kind} inputs)"
        for name, (err, tol) in errs.items():
            ok = err <= tol
            log(f"[ssm] {tag} {desc} {name}: max_abs_err={err:.3e} "
                f"tol={tol:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"ssm {tag} {name} outside tolerance")
            kern = "ssm_scan" if name in ("y", "h_S") else "ssm_scan_bwd"
            recs[kern]["max_abs_err"] = max(recs[kern]["max_abs_err"], err)
        reps = reps_main if tag == SSM_MAIN else 5
        xs = [t.clone().requires_grad_() for t in (A, X, C)]
        graph = ssm_ref.ssm_scan_ref(*xs)
        times = {
            "forward": (
                cuda_ms(lambda: ssm_ops.forward(A, X, C, keep=True), reps),
                cuda_ms(lambda: ssm_ref.ssm_scan_ref(A, X, C), 3, warmup=1)),
            "backward": (
                cuda_ms(lambda: ssm_ops.backward(A, X, C, hck, dy), reps),
                cuda_ms(lambda: torch.autograd.grad(graph, xs, dy,
                                                    retain_graph=True),
                        3, warmup=1))}
        for (direction, (ms, plain)), (_, (b_ms, by, flops, nbytes)) in zip(
                times.items(), ssm_bound(shape).items()):
            log(f"[ssm] {tag} {direction}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound {b_ms:.4f} ms ({by}: "
                f"{nbytes / 1e9:.3f} GB at 3.35 TB/s, {flops / 1e9:.2f} "
                f"GFLOP at 67 (fp32) TFLOP/s); kernel at "
                f"{nbytes / ms / 1e9:.1f} GB/s")
            if tag == SSM_MAIN:
                kern = "ssm_scan" if direction == "forward" else \
                    "ssm_scan_bwd"
                recs[kern].update(ms=ms, plain_ms=plain, library_ms=None,
                                  bound_ms=b_ms, bound_by=by)
        del A, X, C, dy, dhS, hck, xs, graph
        torch.cuda.empty_cache()
    return recs


# --------------------------------------------------------------------------- #
# flash attention, backward (phase 2)
# --------------------------------------------------------------------------- #
# jamba's attention layer in training (B 1, S 2048, 32 heads over 8 KV
# heads of 128, bf16), phi3-mini's prefill shape, a ragged length and a
# head size of 16, a non-causal cross shape, and whisper-large-v3 in
# training (phase 17): its encoder (1500 x 1500 frames) and its decoder's
# cross-attention (448 tokens over 1500 frames), non-causal at hd 64,
# 1500 ragged against every tile; the training shapes of smollm-135m
# (phase 23), olmoe-1b-7b (phase 24: 16 heads of 128, MHA) and
# whisper-large-v3's decoder self-attention (phase 24: 448 tokens), causal
FLASH_BWD_SHAPES = [
    ("jamba attention", 1, 2048, 2048, 32, 8, 128, True, torch.bfloat16),
    ("phi3-mini-3.8b prefill", 4, 2048, 2048, 32, 32, 96, True,
     torch.bfloat16),
    ("ragged causal", 2, 1000, 1000, 9, 3, 64, True, torch.float32),
    ("hd 16", 2, 300, 300, 4, 2, 16, True, torch.float32),
    ("ragged causal bf16", 2, 1000, 1000, 9, 3, 64, True, torch.bfloat16),
    ("hd 16 bf16", 2, 300, 300, 4, 2, 16, True, torch.bfloat16),
    ("cross, non-causal bf16", 2, 77, 300, 4, 2, 32, False, torch.bfloat16),
    ("whisper-large-v3 encoder bf16", 4, 1500, 1500, 20, 20, 64, False,
     torch.bfloat16),
    ("whisper-large-v3 cross bf16", 4, 448, 1500, 20, 20, 64, False,
     torch.bfloat16),
    ("smollm-135m train", 8, 1024, 1024, 9, 3, 64, True, torch.bfloat16),
    ("olmoe-1b-7b train", 4, 1024, 1024, 16, 16, 128, True, torch.bfloat16),
    ("whisper-large-v3 decoder train", 4, 448, 448, 20, 20, 64, True,
     torch.bfloat16),
]
FLASH_BWD_MAIN = "jamba attention"
# small shapes for the card test (tests/test_torch_models.py), each kind in
# fp32 and in bf16
FLASH_BWD_CARD_TEST_SHAPES = [
    ("bf16-gqa-hd64", 2, 256, 256, 9, 3, 64, True, torch.bfloat16),
    ("fp32-ragged-hd96", 1, 200, 200, 4, 4, 96, True, torch.float32),
    ("fp32-rect-causal-hd24", 2, 77, 300, 4, 2, 24, True, torch.float32),
    ("fp32-cross-hd32", 2, 77, 130, 4, 1, 32, False, torch.float32),
    ("bf16-ragged-hd96", 1, 200, 200, 4, 4, 96, True, torch.bfloat16),
    ("bf16-rect-causal-hd24", 2, 77, 300, 4, 2, 24, True, torch.bfloat16),
    ("bf16-cross-hd32", 2, 77, 130, 4, 1, 32, False, torch.bfloat16),
    ("bf16-mqa-hd128", 1, 300, 300, 8, 1, 128, True, torch.bfloat16),
    ("fp32-mqa-hd128", 1, 300, 300, 8, 1, 128, True, torch.float32),
]
# the gradients against autograd of the plain version, over the largest
# magnitude of each: fp32, 1e-4 (both compute in fp32; a gradient sums
# up to Sk products of terms of both signs in another order).  bf16 adds
# 2^-7: the kernel rounds its output to bf16 before D = rowsum(dO o O),
# where autograd of the plain version uses the unrounded fp32 output, and
# rounds the gradients to bf16
FLASH_BWD_RTOL = 1e-4
FLASH_BWD_RTOL_BF16 = 2.0 ** -7


def flash_bwd_error(shape, dev, seed=0):
    """The forward kernel's log-sum-exp and the backward kernel's
    gradients against the plain versions on the same inputs at one shape:
    lse against ``ref.attention_lse_ref``, (dq, dk, dv) against autograd of
    ``ref.attention_ref``.  Returns ({output: (max_abs_err, tolerance)},
    (q, k, v, out, lse, dout))."""
    q, k, v = flash_inputs(shape, dev, seed)
    causal = shape[7]
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dout = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
    out, lse = flash_ops.forward(q, k, v, causal, with_lse=True)
    grads = flash_ops.backward(q, k, v, out, lse, dout, causal)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_ref.attention_ref(*xs, causal=causal),
                               xs, dout)
    _, want_lse = flash_ref.attention_lse_ref(q, k, v, causal=causal)
    rtol = FLASH_BWD_RTOL + (FLASH_BWD_RTOL_BF16
                             if q.dtype == torch.bfloat16 else 0.0)
    errs = {"lse": (_max_err(lse, want_lse),
                    FLASH_BWD_RTOL * float(want_lse.abs().max()))}
    for name, got, w in zip(("dq", "dk", "dv"), grads, want):
        assert bool(torch.isfinite(got).all()), name
        errs[name] = (_max_err(got.float(), w.float()),
                      rtol * float(w.float().abs().max()))
    return errs, (q, k, v, out, lse, dout)


def flash_bwd_bound(shape):
    """Least time of one backward call: five products of the unmasked
    (q, k) pairs (S, dP, dV, dK, dQ; 2 hd flops each per pair and head)
    over the dense bf16 tensor-core rate (the fp32 rate for fp32 inputs),
    and q, k, v, out, dout and lse read once and dq, dk, dv written once
    over the memory rate.  Returns (bound_ms, by, flops, bytes)."""
    _, B, Sq, Sk, H, KV, hd, causal, dtype = shape
    _, _, fwd_flops, _ = flash_bound(shape)
    flops = fwd_flops * 5 / 2
    es = 2 if dtype == torch.bfloat16 else 4
    nbytes = es * (4 * B * Sq * H * hd + 4 * B * Sk * KV * hd) \
        + 4 * B * H * Sq
    t_ops = flops / (PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def library_sdpa_bwd(q, k, v, dout, causal):
    """The backward alone of ``scaled_dot_product_attention`` under
    autograd on the same inputs (its graph built once); a yardstick timed
    here only, never called by the port."""
    import torch.nn.functional as F
    xs = [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*xs, is_causal=causal,
                                         enable_gqa=True)
    g = dout.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, xs, g, retain_graph=True)


def check_flash_bwd_kernel(dev, reps_main: int):
    """Phase 2, flash attention backward: the kernel against autograd of
    the plain version at the ``FLASH_BWD_SHAPES``, each timed beside that
    plain backward, the library's backward and the bound, the bf16 kernels
    also run twice and held bitwise equal.  Returns the
    record of the kernels line (worst error over all shapes; times and
    bound at ``FLASH_BWD_MAIN``)."""
    rec = {"max_abs_err": 0.0}
    for shape in FLASH_BWD_SHAPES:
        tag, B, Sq, Sk, H, KV, hd, causal, dtype = shape
        errs, (q, k, v, out, lse, dout) = flash_bwd_error(shape, dev)
        torch.cuda.synchronize()
        desc = (f"B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} "
                f"{'causal' if causal else 'non-causal'} "
                f"{str(dtype).split('.')[-1]}")
        for name, (err, tol) in errs.items():
            ok = err <= tol
            log(f"[flash-bwd] {tag} {desc} {name}: max_abs_err={err:.3e} "
                f"tol={tol:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash bwd {tag} {name} outside "
                                     "tolerance")
            if name != "lse":
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if dtype == torch.bfloat16:
            check_deterministic(
                f"flash-bwd {tag}",
                lambda: flash_ops.backward(q, k, v, out, lse, dout, causal))
        reps = reps_main if tag == FLASH_BWD_MAIN else 5
        ms = cuda_ms(lambda: flash_ops.backward(q, k, v, out, lse, dout,
                                                causal), reps)
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        graph = flash_ref.attention_ref(*xs, causal=causal)
        plain = cuda_ms(lambda: torch.autograd.grad(graph, xs, dout,
                                                    retain_graph=True),
                        3, warmup=1)
        lib = cuda_ms(library_sdpa_bwd(q, k, v, dout, causal), reps)
        b_ms, by, flops, nbytes = flash_bwd_bound(shape)
        log(f"[flash-bwd] {tag}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"library backward {lib:.4f} ms, bound {b_ms:.4f} ms ({by}: "
            f"{flops / 1e9:.2f} GFLOP at "
            f"{'989 (bf16 tensor)' if dtype == torch.bfloat16 else '67 (fp32)'}"
            f" TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 TB/s); kernel at "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        if tag == FLASH_BWD_MAIN:
            rec.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                       bound_by=by)
        del q, k, v, out, lse, dout, xs, graph
        torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------------------- #
# flash attention with a given causal diagonal (phase 2)
# --------------------------------------------------------------------------- #
# (tag, B, Sq, Sk, H, KV, hd, dtype, causal_offset), each causal: the last of
# 16 key shards of smollm-135m's training shape (phase 25's kvseq: 1024
# query rows over 64 keys, offset -960, so the first 960 rows see no key),
# the last row shard of its qseq split (64 rows over all 1024 keys, offset
# 960), and Sq > Sk at a reduced head size; each in bf16 (the tensor-core
# kernels) and fp32 (the FMA kernels)
FLASH_OFFSET_SHAPES = [
    ("kvseq shard bf16", 2, 1024, 64, 9, 3, 64, torch.bfloat16, -960),
    ("qseq shard bf16", 2, 64, 1024, 9, 3, 64, torch.bfloat16, 960),
    ("Sq > Sk hd 24 bf16", 2, 300, 77, 4, 2, 24, torch.bfloat16, 10),
    ("kvseq shard fp32", 2, 1024, 64, 9, 3, 64, torch.float32, -960),
    ("qseq shard fp32", 2, 64, 1024, 9, 3, 64, torch.float32, 960),
    ("Sq > Sk hd 24 fp32", 2, 300, 77, 4, 2, 24, torch.float32, 10),
]


def flash_offset_errors(shape, dev, seed=0):
    """The forward and backward kernels with ``causal_offset`` against the
    plain versions on the same inputs: out and lse against
    ``ref.attention_lse_ref`` (+inf, never NaN, on the same rows: those
    that see no key), (dq, dk, dv) against autograd of
    ``ref.attention_ref``, at phase 2's tolerances.  Returns ({output:
    (max_abs_err, tolerance)}, (q, k, v, out, lse, dout))."""
    tag, B, Sq, Sk, H, KV, hd, dtype, off = shape
    q, k, v = flash_inputs((tag, B, Sq, Sk, H, KV, hd, True, dtype), dev,
                           seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dout = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    out, lse = flash_ops.forward(q, k, v, True, with_lse=True,
                                 causal_offset=off)
    grads = flash_ops.backward(q, k, v, out, lse, dout, True,
                               causal_offset=off)
    want, want_lse = flash_ref.attention_lse_ref(q, k, v, causal=True,
                                                 offset=off)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    want_g = torch.autograd.grad(
        flash_ref.attention_ref(*xs, causal=True, offset=off), xs, dout)
    for name, t in [("out", out), ("lse", lse)] + list(zip(
            ("dq", "dk", "dv"), grads)):
        if bool(torch.isnan(t).any()):
            raise AssertionError(f"flash offset {tag}: NaN in {name}")
    if not torch.equal(torch.isinf(lse), torch.isinf(want_lse)):
        raise AssertionError(f"flash offset {tag}: rows without a key "
                             "differ")
    fin = torch.isfinite(want_lse)
    bf16 = dtype == torch.bfloat16
    tol = 2e-5 + (2.0 ** -7 * float(want.float().abs().max()) if bf16
                  else 0.0)
    errs = {"out": (_max_err(out.float(), want.float()), tol),
            "lse": (_max_err(lse[fin], want_lse[fin]),
                    FLASH_BWD_RTOL * float(want_lse[fin].abs().max()))}
    rtol = FLASH_BWD_RTOL + (FLASH_BWD_RTOL_BF16 if bf16 else 0.0)
    for name, got, w in zip(("dq", "dk", "dv"), grads, want_g):
        errs[name] = (_max_err(got.float(), w.float()),
                      rtol * float(w.float().abs().max()))
    return errs, (q, k, v, out, lse, dout)


def check_flash_offsets(dev, recs):
    """Phase 2, the flash kernels with a given causal diagonal at the
    ``FLASH_OFFSET_SHAPES``: each output within tolerance, the bf16
    kernels run twice and held bitwise equal; the worst errors go into the
    kernels line's records ``recs``."""
    n_empty = 0
    for shape in FLASH_OFFSET_SHAPES:
        tag, B, Sq, Sk, H, KV, hd, dtype, off = shape
        errs, (q, k, v, out, lse, dout) = flash_offset_errors(shape, dev)
        n_empty = int(torch.isinf(lse).sum())
        for name, (err, tol) in errs.items():
            ok = err <= tol
            log(f"[flash-offset] {tag} B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} "
                f"hd={hd} causal_offset={off} {name}: max_abs_err={err:.3e} "
                f"tol={tol:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash offset {tag} {name} outside "
                                     "tolerance")
            if name == "out":
                recs["flash_attention"]["max_abs_err"] = max(
                    recs["flash_attention"]["max_abs_err"], err)
            elif name != "lse":
                recs["flash_attention_bwd"]["max_abs_err"] = max(
                    recs["flash_attention_bwd"]["max_abs_err"], err)
        log(f"[flash-offset] {tag}: {n_empty} (row, head) pairs see no key "
            "(lse +inf, out 0)")
        if dtype == torch.bfloat16:
            check_deterministic(
                f"flash offset {tag}",
                lambda: flash_ops.forward(q, k, v, True, with_lse=True,
                                          causal_offset=off))
            check_deterministic(
                f"flash-bwd offset {tag}",
                lambda: flash_ops.backward(q, k, v, out, lse, dout, True,
                                           causal_offset=off))
        del q, k, v, out, lse, dout


# --------------------------------------------------------------------------- #
# xLSTM training and serving (phases 10-12)
# --------------------------------------------------------------------------- #
# full width and depth, bf16: B 2 x S 1024 (2,048 tokens a step) fits the
# card with every activation kept (PERF.md section 5 has the byte count)
TRAIN = dict(arch="xlstm-1.3b", batch=2, seq=1024, steps=4)
# fp32 card-vs-CPU parity on the reduced config (7 mLSTM + 1 sLSTM layers,
# dh 64), a ragged length.  Each step starts the CPU from a copy of the
# card's state, so the check holds each step's arithmetic, the AdamW update
# included: losses and grad norms differ only by the order of fp32 sums (the
# kernel's, cuBLAS's and the CPU's; the mLSTM gate gradients sum terms of
# mixed sign), measured at up to 1.4e-7 and 1.9e-6.  AdamW m and v agree
# within LEAF_RTOL of each leaf's largest entry for the weight matrices.  A
# 1-D leaf (a gate bias, a norm scale) has one gradient entry summed over
# all B x S tokens of per-token terms of both signs, which largely cancel
# at initialisation, so the rounding of the per-token terms (the kernel's
# gate gradients agree within ~5e-6 of their largest, phase 2) is large
# against the sum: those leaves agree within VECTOR_RTOL (measured 3.3e-4
# on the first step, below 5e-5 once m has a history).  The parameters,
# where |m| is above 1e-3 of its leaf's largest, agree within PARAM_LR_TOL
# learning rates (the update m / sqrt(v) of an entry whose gradient is
# near zero is a ratio of rounding errors, so those are not compared).
# Two free-running trainings part instead: AdamW's normalised steps move
# every parameter by about lr whatever the size of its gradient, so
# rounding in near-zero gradient entries grows into parameter differences.
# The phase prints that drift for the card against a free-running CPU
# training, and, as a witness that rounding alone parts them, for two CPU
# trainings whose only difference is the order of the mLSTM gradient's
# sums: autograd of the plain chunkwise form against the backward kernel's
# decomposition of the same function (``ref.mlstm_chunkwise_bwd``).
TRAIN_PARITY = dict(arch="xlstm-1.3b", batch=4, seq=130, steps=5)
TRAIN_LOSS_RTOL = 2e-5
TRAIN_GNORM_RTOL = 1e-4
LEAF_RTOL = 1e-4
VECTOR_RTOL = 1e-3
PARAM_LR_TOL = 1e-2
XLSTM_SERVE = ("xlstm-1.3b", 2, 256, 8)


def train_path(dev):
    """Phase 10: xlstm-1.3b at full width and depth, bf16, through
    ``launch.train.run`` for ``TRAIN["steps"]`` steps.  The mLSTM counters
    are set to 0 just before the run and read just after: each step
    launches the forward kernel once per mLSTM layer and the backward
    kernel once per mLSTM layer.  Returns the counts."""
    cfg = get_config(TRAIN["arch"])
    n_mlstm = sum(spec.mixer == "mlstm" for spec in layer_specs(cfg))
    args = train.make_parser().parse_args(
        ["--arch", TRAIN["arch"], "--batch", str(TRAIN["batch"]), "--seq",
         str(TRAIN["seq"]), "--steps", str(TRAIN["steps"]), "--remat",
         "none", "--print-every", "1"])
    _reset(mlstm_ops.launches)
    r = train.run(args)
    counts = dict(mlstm_ops.launches)
    toks = TRAIN["batch"] * TRAIN["seq"]
    for i, (loss, gn, s, n) in enumerate(zip(
            r["losses"], r["grad_norms"], r["step_s"], r["mlstm_launches"])):
        log(f"[train] {TRAIN['arch']} bf16 B={TRAIN['batch']} "
            f"S={TRAIN['seq']} step {i}: loss {loss:.5f} grad_norm "
            f"{gn:.4f} step {s * 1e3:.1f} ms ({toks / s:.0f} tokens/s, host "
            f"clock, synchronized), mlstm launches {n}")
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError("non-finite loss or grad norm")
        if n != {"forward": n_mlstm, "backward": n_mlstm}:
            raise AssertionError(f"step {i}: {n} mlstm launches, expected "
                                 f"{n_mlstm} each way")
    steady = r["step_s"][1:] or r["step_s"]
    log(f"[train] {r['n_params']:,} parameters; steps after the first: "
        f"{1e3 * sum(steady) / len(steady):.1f} ms mean "
        f"({toks * len(steady) / sum(steady):.0f} tokens/s); peak memory "
        f"{r['peak_mem_gib']:.2f} GiB; mlstm launches in the run {counts}")
    if counts != {"mlstm_chunk": n_mlstm * TRAIN["steps"],
                  "mlstm_chunk_bwd": n_mlstm * TRAIN["steps"]}:
        raise AssertionError(f"main path launches {counts}")
    del r
    torch.cuda.empty_cache()
    return counts


def _copy_to(tree, dev):
    """A copy of a state or parameter tree with its tensors on ``dev``."""
    return tree_map(lambda t: t.to(dev, copy=True) if torch.is_tensor(t)
                    else t, tree)


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def _state_errors(got, want, lr):
    """Worst errors of the card's state ``got`` against the CPU's ``want``
    after one step from the same state: AdamW m and v over each leaf's
    largest entry, for matrices and for 1-D leaves apart, with the worst
    leaf's path; the parameters where |m| is above 1e-3 of its leaf's
    largest, in learning rates."""
    err = {"params": 0.0}
    for key in ("m", "v"):
        got_k = dict(tree_items(got["opt"][key]))
        for path, w in tree_items(want["opt"][key]):
            scale = max(float(w.abs().max()), 1e-30)
            e = float((got_k[path].cpu() - w).abs().max()) / scale
            kind = f"{key}_1d" if w.dim() < 2 else key
            if e >= err.get(kind, (0.0, None))[0]:
                err[kind] = (e, "/".join(map(str, path)))
    m_want = dict(tree_items(want["opt"]["m"]))
    got_p = dict(tree_items(got["params"]))
    for path, w in tree_items(want["params"]):
        m = m_want[path].abs()
        sure = m > 1e-3 * float(m.max())
        d = (got_p[path].cpu().float() - w.float())[sure]
        if d.numel():
            err["params"] = max(err["params"], float(d.abs().max()) / lr)
    return err


def _step_rows(s, m_gpu, m_cpu, state_gpu, state_cpu, bad):
    """Step ``s`` of the card against the same step on the CPU from the same
    state: loss and grad norm, AdamW m and v, the parameters where |m| is
    not near zero, each against its tolerance.  Appends what is outside to
    ``bad``; returns the printed pieces."""
    row = []
    for key, tol in (("loss", TRAIN_LOSS_RTOL),
                     ("grad_norm", TRAIN_GNORM_RTOL)):
        a, b = float(m_gpu[key]), float(m_cpu[key])
        rel = _rel(a, b)
        if not (math.isfinite(a) and rel <= tol):
            bad.append((s, key, rel))
        row.append(f"{key} {a:.7f} card / {b:.7f} cpu (rel {rel:.2e}, "
                   f"tol {tol:.0e})")
    err = _state_errors(state_gpu, state_cpu, float(m_cpu["lr"]))
    for key, tol in (("m", LEAF_RTOL), ("v", LEAF_RTOL),
                     ("m_1d", VECTOR_RTOL), ("v_1d", VECTOR_RTOL)):
        e, path = err[key]
        if not e <= tol:
            bad.append((s, key, e, path))
        row.append(f"{key} {e:.2e} of its leaf's largest at {path} (tol "
                   f"{tol:.0e})")
    if not err["params"] <= PARAM_LR_TOL:
        bad.append((s, "params", err["params"]))
    row.append(f"params {err['params']:.2e} lr (tol {PARAM_LR_TOL:.0e})")
    return row


class _KernelOrderMixer(torch.autograd.Function):
    """The plain chunkwise mLSTM whose backward is the backward kernel's
    decomposition in plain PyTorch: the same function and gradient as
    autograd of it, with the sums in the kernel's order."""

    @staticmethod
    def forward(ctx, q, k, v, logi, logf):
        h = mlstm_ref.mlstm_chunkwise(q, k, v, logi, logf)
        ctx.save_for_backward(q, k, v, logi, logf, h)
        return h

    @staticmethod
    def backward(ctx, g):
        return mlstm_ref.mlstm_chunkwise_bwd(*ctx.saved_tensors,
                                             g.contiguous())


def _kernel_order_step(step):
    """``step`` with every mLSTM mixer of the model differentiated in the
    backward kernel's order (CPU only)."""
    def run(state, batch):
        plain = mlstm_ops.mlstm_mixer
        mlstm_ops.mlstm_mixer = _KernelOrderMixer.apply
        try:
            return step(state, batch)
        finally:
            mlstm_ops.mlstm_mixer = plain
    return run


def train_parity_path(dev):
    """Phase 11: the reduced xLSTM trained for ``TRAIN_PARITY["steps"]``
    fp32 steps on the card; before each step the CPU plain path takes a
    copy of the card's state and runs the same step on the same batch.
    Losses, grad norms, AdamW moments and the well-conditioned parameters
    agree within their tolerances, and the card's steps run both kernels.
    Two free-running CPU trainings from the card's first state (one with
    the mLSTM gradient's sums in the kernel's order) measure the drift."""
    cfg = get_config(TRAIN_PARITY["arch"], reduced=True)
    B, S = TRAIN_PARITY["batch"], TRAIN_PARITY["seq"]
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32,
                 ce_chunk=min(S, 512), ssm_chunk=min(S, 256),
                 remat_policy="none")
    hyper = TrainHyper(opt=AdamWConfig(lr=3e-3, warmup_steps=2,
                                       total_steps=TRAIN_PARITY["steps"]))
    state_gpu = init_train_state(torch.Generator(device=dev).manual_seed(0),
                                 cfg, rt)
    free = [_copy_to(state_gpu, torch.device("cpu")) for _ in range(2)]
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=1234))
    step_cpu = make_train_step(cfg, rt, hyper)
    step_gpu = make_train_step(cfg, rt, hyper)
    steps_free = [step_cpu, _kernel_order_step(step_cpu)]
    _reset(mlstm_ops.launches)
    bad = []
    for s in range(TRAIN_PARITY["steps"]):
        batch = data.batch_at(s)
        cpu_batch = {k: torch.as_tensor(a) for k, a in batch.items()}
        state_cpu = _copy_to(state_gpu, torch.device("cpu"))
        state_cpu, m_cpu = step_cpu(state_cpu, cpu_batch)
        state_gpu, m_gpu = step_gpu(state_gpu, {
            k: torch.as_tensor(a, device=dev) for k, a in batch.items()})
        row = _step_rows(s, m_gpu, m_cpu, state_gpu, state_cpu, bad)
        log(f"[train-parity] step {s}: " + ", ".join(row))
        ms_free = []
        for i, fn in enumerate(steps_free):
            free[i], m = fn(free[i], cpu_batch)
            ms_free.append(m)
        log(f"[train-drift] step {s}, free-running: card vs cpu loss rel "
            f"{_rel(m_gpu['loss'], ms_free[0]['loss']):.2e} grad_norm rel "
            f"{_rel(m_gpu['grad_norm'], ms_free[0]['grad_norm']):.2e}; cpu "
            f"autograd vs kernel-order mLSTM backward loss rel "
            f"{_rel(ms_free[1]['loss'], ms_free[0]['loss']):.2e} grad_norm "
            f"rel {_rel(ms_free[1]['grad_norm'], ms_free[0]['grad_norm']):.2e}")
    n_mlstm = sum(spec.mixer == "mlstm" for spec in layer_specs(cfg))
    want = n_mlstm * TRAIN_PARITY["steps"]
    log(f"[train-parity] reduced {TRAIN_PARITY['arch']} fp32 B={B} S={S}, "
        f"{TRAIN_PARITY['steps']} steps: outside tolerance {bad}, mlstm "
        f"launches {dict(mlstm_ops.launches)}")
    if bad:
        raise AssertionError("card and CPU training disagree")
    if mlstm_ops.launches != {"mlstm_chunk": want, "mlstm_chunk_bwd": want}:
        raise AssertionError("the card's steps missed an mlstm kernel")


def xlstm_serve_path(dev):
    """Phase 12: xlstm-1.3b served at full width and depth in bf16 through
    ``launch.serve.run``: prefill and decode carry state, so neither
    launches the mLSTM kernel (as in the reference)."""
    arch, B, P, gen = XLSTM_SERVE
    args = serve.make_parser().parse_args(
        ["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
         "--gen", str(gen)])
    torch.cuda.reset_peak_memory_stats(dev)
    r = serve.run(args)
    mem = torch.cuda.max_memory_allocated(dev)
    log(f"[serve] {arch} bf16 B={B} prompt={P} gen={gen}: prefill "
        f"{r['prefill_s'] * 1e3:.2f} ms, decode {r['decode_s'] * 1e3:.2f} ms "
        f"for {gen - 1} steps ({r['decode_tok_s']:.1f} tokens/s), peak "
        f"memory {mem / 2**30:.2f} GiB, mlstm launches "
        f"{r['mlstm_launches']}, generated {r['generated_shape']}, sample "
        f"{r['sample']}")
    if not r["logits_finite"] or r["generated_shape"] != [B, gen]:
        raise AssertionError(f"{arch}: non-finite logits or wrong shape")
    if r["mlstm_launches"] != {"prefill": 0, "decode": 0}:
        raise AssertionError("serving launched the mlstm kernel")


def profile_train(dev):
    """``--profile``: where a training step's time goes, at full width and
    one period of depth (7 mLSTM + 1 sLSTM layers), bf16, B 2, S 1024:
    one untimed step, then one under the profiler."""
    import dataclasses
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              n_layers=len(get_config(TRAIN["arch"]).period))
    B, S = TRAIN["batch"], TRAIN["seq"]
    rt = Runtime(ce_chunk=min(S, 512), ssm_chunk=min(S, 256),
                 remat_policy="none")
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg,
                             rt)
    step = make_train_step(cfg, rt, TrainHyper())
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=1234))
    batch = {k: torch.as_tensor(a, device=dev)
             for k, a in data.batch_at(0).items()}
    step(state, batch)
    _, wall, prof = _profiled(lambda: step(state, batch))
    _report_profile(prof, wall, f"{TRAIN['arch']} train step, 8 layers, "
                                f"B={B} S={S}")


# --------------------------------------------------------------------------- #
# jamba training and serving (phases 13-15)
# --------------------------------------------------------------------------- #
# jamba-v0.1-52b at full width (d 4096, 32 heads over 8 KV heads of 128,
# d_ff 14336, d_inner 8192, N 16, 16 experts top-2 of 14336, vocab 65,536),
# its period cut to one layer of each kind it has (its positions 0, 1 and
# 4): 3,960,356,864 parameters, which with AdamW's fp32 moments and the
# fp32 accumulated gradients fit one 80 GB card at B 1 x S 2048
JAMBA_TRAIN = dict(arch="jamba-v0.1-52b", batch=1, seq=2048, steps=4)
# fp32 card-vs-CPU parity on the reduced jamba (7 Mamba + 1 attention
# layers, MoE on every other, d 64, d_inner 128, N 8), a ragged length; the
# tolerances of phase 11.  A token whose router probabilities are near-tied
# may pick another expert on the card than on the CPU; the phase prints the
# smallest gap between a token's k-th and (k+1)-th router probabilities
JAMBA_PARITY = dict(arch="jamba-v0.1-52b", batch=4, seq=130, steps=5)
JAMBA_SERVE = dict(arch="jamba-v0.1-52b", batch=2, prompt=1024, gen=16)
JAMBA_SERVE_PARITY = dict(arch="jamba-v0.1-52b", reduced=True, B=2, P=130,
                          gen=8)


def jamba_cut():
    """jamba-v0.1-52b at full width, one Mamba + dense, one Mamba + MoE and
    one attention + dense layer."""
    import dataclasses
    from repro_torch.configs.base import LayerSpec
    return dataclasses.replace(
        get_config(JAMBA_TRAIN["arch"]), n_layers=3,
        period=(LayerSpec("mamba", "dense"), LayerSpec("mamba", "moe"),
                LayerSpec("attn", "dense")))


def _mixers(cfg, kind):
    return sum(spec.mixer == kind for spec in layer_specs(cfg))


def jamba_train_path(dev):
    """Phase 13: the cut jamba at full width, bf16, through
    ``launch.train.run``.  The scan and flash counters are set to 0 just
    before the run and read just after: each step launches the scan's
    forward and backward kernels once per Mamba layer and the flash
    forward and backward kernels once per attention layer.  Returns the
    counts."""
    cfg = jamba_cut()
    n_mamba, n_attn = _mixers(cfg, "mamba"), _mixers(cfg, "attn")
    T = JAMBA_TRAIN
    args = train.make_parser().parse_args(
        ["--arch", T["arch"], "--batch", str(T["batch"]), "--seq",
         str(T["seq"]), "--steps", str(T["steps"]), "--remat", "none",
         "--print-every", "1"])
    _reset(ssm_ops.launches, flash_ops.launches, mlstm_ops.launches)
    r = train.run(args, cfg=cfg)
    counts = {**ssm_ops.launches, **flash_ops.launches}
    toks = T["batch"] * T["seq"]
    want = {"ssm_launches": {"forward": n_mamba, "backward": n_mamba},
            "flash_launches": {"forward": n_attn, "backward": n_attn},
            "mlstm_launches": {"forward": 0, "backward": 0}}
    for i, (loss, gn, st, drop) in enumerate(zip(
            r["losses"], r["grad_norms"], r["step_s"], r["moe_drop_frac"])):
        got = {k: r[k][i] for k in want}
        log(f"[jamba-train] {cfg.name} cut to 3 layers, bf16 B={T['batch']} "
            f"S={T['seq']} step {i}: loss {loss:.5f} grad_norm {gn:.4f} step "
            f"{st * 1e3:.1f} ms ({toks / st:.0f} tokens/s, host clock, "
            f"synchronized), moe_drop_frac {drop:.4f}, launches {got}")
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError("non-finite loss or grad norm")
        if got != want:
            raise AssertionError(f"step {i}: launches {got}, expected {want}")
    steady = r["step_s"][1:] or r["step_s"]
    log(f"[jamba-train] {r['n_params']:,} parameters; steps after the "
        f"first: {1e3 * sum(steady) / len(steady):.1f} ms mean "
        f"({toks * len(steady) / sum(steady):.0f} tokens/s); peak memory "
        f"{r['peak_mem_gib']:.2f} GiB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.2f}; "
        f"launches in the run {counts}")
    n = T["steps"]
    if counts != {"ssm_scan": n_mamba * n, "ssm_scan_bwd": n_mamba * n,
                  "flash_attention": n_attn * n,
                  "flash_attention_bwd": n_attn * n}:
        raise AssertionError(f"main path launches {counts}")
    del r
    torch.cuda.empty_cache()
    return counts


def _router_gap(state, batch, cfg, rt):
    """The smallest gap, over tokens and MoE layers, between a token's k-th
    and (k+1)-th router probability in the forward of ``batch`` (CPU):
    below a few ulps, the two devices may route the token differently."""
    from repro_torch.models import moe as moe_mod
    gaps = []
    real = moe_mod.moe

    def spy(p, x, cfg_, rt_):
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        top = torch.topk(probs, cfg_.top_k + 1, dim=-1).values
        gaps.append(float((top[..., -2] - top[..., -1]).min()))
        return real(p, x, cfg_, rt_)

    from repro_torch.models import transformer as tr
    tr.moe = spy
    try:
        with torch.no_grad():
            tr.forward_train(state["params"], batch, cfg, rt)
    finally:
        tr.moe = real
    return min(gaps)


def jamba_parity_path(dev):
    """Phase 14: the reduced jamba trained for ``JAMBA_PARITY["steps"]``
    fp32 steps on the card; before each step the CPU plain path takes a
    copy of the card's state and runs the same step on the same batch.
    Losses, grad norms, AdamW moments and the well-conditioned parameters
    agree within phase 11's tolerances, and every card step runs the scan
    and flash kernels, forward and backward."""
    cfg = get_config(JAMBA_PARITY["arch"], reduced=True)
    B, S = JAMBA_PARITY["batch"], JAMBA_PARITY["seq"]
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32,
                 ce_chunk=min(S, 512), remat_policy="none")
    hyper = TrainHyper(opt=AdamWConfig(lr=3e-3, warmup_steps=2,
                                       total_steps=JAMBA_PARITY["steps"]))
    state_gpu = init_train_state(torch.Generator(device=dev).manual_seed(0),
                                 cfg, rt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=1234))
    step = make_train_step(cfg, rt, hyper)
    _reset(ssm_ops.launches, flash_ops.launches)
    bad = []
    for s in range(JAMBA_PARITY["steps"]):
        batch = data.batch_at(s)
        cpu_batch = {k: torch.as_tensor(a) for k, a in batch.items()}
        state_cpu = _copy_to(state_gpu, torch.device("cpu"))
        gap = _router_gap(state_cpu, cpu_batch, cfg, rt)
        state_cpu, m_cpu = step(state_cpu, cpu_batch)
        state_gpu, m_gpu = step(state_gpu, {
            k: torch.as_tensor(a, device=dev) for k, a in batch.items()})
        row = _step_rows(s, m_gpu, m_cpu, state_gpu, state_cpu, bad)
        for key in ("moe_drop_frac", "moe_lb_loss"):
            row.append(f"{key} {float(m_gpu[key]):.6f} card / "
                       f"{float(m_cpu[key]):.6f} cpu")
        row.append(f"smallest router gap {gap:.3e}")
        log(f"[jamba-parity] step {s}: " + ", ".join(row))
    n_mamba, n_attn = _mixers(cfg, "mamba"), _mixers(cfg, "attn")
    n = JAMBA_PARITY["steps"]
    counts = {**ssm_ops.launches, **flash_ops.launches}
    log(f"[jamba-parity] reduced {cfg.name} fp32 B={B} S={S}, {n} steps: "
        f"outside tolerance {bad}, launches {counts}")
    if bad:
        raise AssertionError("card and CPU training disagree")
    if counts != {"ssm_scan": n_mamba * n, "ssm_scan_bwd": n_mamba * n,
                  "flash_attention": n_attn * n,
                  "flash_attention_bwd": n_attn * n}:
        raise AssertionError("the card's steps missed a kernel")


def jamba_serve_path(dev):
    """Phase 15: the cut jamba served in bf16 through ``launch.serve.run``:
    one scan launch per Mamba layer and one flash launch per attention
    layer in prefill, none in decode; then the reduced fp32 jamba card vs
    CPU logits (``serve_parity_path``)."""
    cfg = jamba_cut()
    T = JAMBA_SERVE
    args = serve.make_parser().parse_args(
        ["--arch", T["arch"], "--batch", str(T["batch"]), "--prompt-len",
         str(T["prompt"]), "--gen", str(T["gen"])])
    torch.cuda.reset_peak_memory_stats(dev)
    r = serve.run(args, cfg=cfg)
    mem = torch.cuda.max_memory_allocated(dev)
    log(f"[jamba-serve] {cfg.name} cut to 3 layers, bf16 B={T['batch']} "
        f"prompt={T['prompt']} gen={T['gen']}: prefill "
        f"{r['prefill_s'] * 1e3:.2f} ms, decode {r['decode_s'] * 1e3:.2f} ms "
        f"for {T['gen'] - 1} steps ({r['decode_tok_s']:.1f} tokens/s), peak "
        f"memory {mem / 2**30:.2f} GiB, ssm launches {r['ssm_launches']}, "
        f"flash launches {r['flash_launches']}, generated "
        f"{r['generated_shape']}, sample {r['sample']}")
    if r["ssm_launches"] != {"prefill": _mixers(cfg, "mamba"), "decode": 0} \
            or r["flash_launches"] != {"prefill": _mixers(cfg, "attn"),
                                       "decode": 0}:
        raise AssertionError("jamba prefill missed a kernel, or decode "
                             "launched one")
    if not r["logits_finite"] or r["generated_shape"] != [T["batch"],
                                                          T["gen"]]:
        raise AssertionError("jamba: non-finite logits or wrong shape")
    torch.cuda.empty_cache()
    serve_parity_path(dev, JAMBA_SERVE_PARITY)


def profile_jamba_train(dev):
    """``--profile``: where a step of phase 13's training goes (the cut
    jamba, bf16, B 1, S 2048): one untimed step, then one under the
    profiler."""
    cfg = jamba_cut()
    B, S = JAMBA_TRAIN["batch"], JAMBA_TRAIN["seq"]
    rt = Runtime(ce_chunk=min(S, 512), remat_policy="none")
    state = init_train_state(torch.Generator(device=dev).manual_seed(0), cfg,
                             rt)
    step = make_train_step(cfg, rt, TrainHyper())
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=1234))
    batch = {k: torch.as_tensor(a, device=dev)
             for k, a in data.batch_at(0).items()}
    step(state, batch)
    _, wall, prof = _profiled(lambda: step(state, batch))
    _report_profile(prof, wall, f"{cfg.name} train step, 3 layers, B={B} "
                                f"S={S}")
    del state
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# whisper-large-v3 served and trained (phases 16-18)
# --------------------------------------------------------------------------- #
WHISPER = "whisper-large-v3"
# full width and depth, bf16: 1500 stub frames per sequence
WHISPER_SERVE = dict(batch=8, prompt=64, gen=64)
WHISPER_TRAIN = dict(batch=4, seq=448, steps=4)
WHISPER_MEM_GIB = 76.0
# fp32 card-vs-CPU training on the reduced config (2 encoder + 2 decoder
# layers, d 64, 16 frames) with phase 11's tolerances, a ragged length
WHISPER_PARITY = dict(batch=4, seq=130, steps=5)
# fp32 logits card vs CPU at full width, depth cut to 4 + 4 layers, so that
# the fp32 flash kernel meets hd 64 and 1500 keys
WHISPER_SERVE_PARITY = dict(arch=WHISPER, B=2, P=64, gen=8, layers=4)


def whisper_cut(layers):
    """whisper-large-v3 at full width with ``layers`` encoder and
    ``layers`` decoder layers."""
    import dataclasses
    return dataclasses.replace(get_config(WHISPER), n_layers=layers,
                               encoder_layers=layers)


def flash_per_prefill(cfg):
    """Flash forward launches of one prefill (or one training forward):
    one per self-attention layer, per cross-attention and per encoder
    layer."""
    return (_mixers(cfg, "attn") + cfg.encoder_layers
            + sum(spec.cross_attn for spec in layer_specs(cfg)))


def whisper_serve_path(dev):
    """Phase 16: whisper-large-v3 served at full width and depth in bf16
    through ``launch.serve.run`` (stub frames from the seed's stream): the
    flash forward launches once per encoder layer, decoder self-attention
    and cross-attention in prefill (96), never in decode.  Returns the
    prefill's launches."""
    cfg = get_config(WHISPER)
    T = WHISPER_SERVE
    args = serve.make_parser().parse_args(
        ["--arch", WHISPER, "--batch", str(T["batch"]), "--prompt-len",
         str(T["prompt"]), "--gen", str(T["gen"])])
    torch.cuda.reset_peak_memory_stats(dev)
    _reset(flash_ops.launches)
    r = serve.run(args)
    mem = torch.cuda.max_memory_allocated(dev)
    want = flash_per_prefill(cfg)
    log(f"[whisper-serve] {WHISPER} bf16 B={T['batch']} frames="
        f"{cfg.encoder_seq} prompt={T['prompt']} gen={T['gen']}: prefill "
        f"{r['prefill_s'] * 1e3:.2f} ms, decode {r['decode_s'] * 1e3:.2f} ms "
        f"for {T['gen'] - 1} steps ({r['decode_tok_s']:.1f} tokens/s, host "
        f"clock, synchronized), peak memory {mem / 2**30:.2f} GiB, flash "
        f"launches {r['flash_launches']} (expected {want} in prefill), "
        f"generated {r['generated_shape']}, sample {r['sample']}")
    if r["flash_launches"] != {"prefill": want, "decode": 0} or \
            flash_ops.launches["flash_attention"] != want:
        raise AssertionError("whisper prefill missed a flash launch, or "
                             "decode launched one")
    if not r["logits_finite"] or r["generated_shape"] != [T["batch"],
                                                          T["gen"]]:
        raise AssertionError("whisper: non-finite logits or wrong shape")
    torch.cuda.empty_cache()
    return want


def whisper_train_path(dev):
    """Phase 17: whisper-large-v3 at full width and depth, bf16, through
    ``launch.train.run`` (frames from ``train.frames_at``).  The flash
    counters are set to 0 just before the run and read just after: each
    step launches the forward and the backward kernel 96 times (32 encoder
    layers, 32 decoder self-attentions, 32 cross-attentions).  Losses and
    grad norms finite, peak memory below ``WHISPER_MEM_GIB``.  Returns the
    counts."""
    cfg = get_config(WHISPER)
    T = WHISPER_TRAIN
    per = flash_per_prefill(cfg)
    args = train.make_parser().parse_args(
        ["--arch", WHISPER, "--batch", str(T["batch"]), "--seq",
         str(T["seq"]), "--steps", str(T["steps"]), "--remat", "none",
         "--print-every", "1"])
    _reset(flash_ops.launches)
    r = train.run(args)
    counts = dict(flash_ops.launches)
    toks = T["batch"] * T["seq"]
    for i, (loss, gn, st, n) in enumerate(zip(
            r["losses"], r["grad_norms"], r["step_s"], r["flash_launches"])):
        log(f"[whisper-train] {WHISPER} bf16 B={T['batch']} S={T['seq']} "
            f"frames={cfg.encoder_seq} step {i}: loss {loss:.5f} grad_norm "
            f"{gn:.4f} step {st * 1e3:.1f} ms ({toks / st:.0f} decoder "
            f"tokens/s, host clock, synchronized), flash launches {n}")
        if not (math.isfinite(loss) and math.isfinite(gn)):
            raise AssertionError("non-finite loss or grad norm")
        if n != {"forward": per, "backward": per}:
            raise AssertionError(f"step {i}: flash launches {n}, expected "
                                 f"{per} each way")
    steady = r["step_s"][1:] or r["step_s"]
    log(f"[whisper-train] {r['n_params']:,} parameters; steps after the "
        f"first: {1e3 * sum(steady) / len(steady):.1f} ms mean "
        f"({toks * len(steady) / sum(steady):.0f} decoder tokens/s); peak "
        f"memory {r['peak_mem_gib']:.2f} GiB (limit {WHISPER_MEM_GIB}); "
        f"launches in the run {counts}")
    if counts != {"flash_attention": per * T["steps"],
                  "flash_attention_bwd": per * T["steps"]}:
        raise AssertionError(f"main path launches {counts}")
    if not r["peak_mem_gib"] < WHISPER_MEM_GIB:
        raise AssertionError(f"peak memory {r['peak_mem_gib']:.2f} GiB")
    del r
    torch.cuda.empty_cache()
    return counts


def whisper_parity_path(dev):
    """Phase 18: the reduced whisper trained ``WHISPER_PARITY["steps"]``
    fp32 steps on the card, each step also run on the CPU plain path from a
    copy of the card's state, with phase 11's tolerances; every card step
    runs the flash forward and backward (fp32 kernels) once per encoder
    layer, self- and cross-attention.  Then the fp32 logits of whisper at
    full width cut to 4 + 4 layers, card vs CPU (``serve_parity_path``)."""
    cfg = get_config(WHISPER, reduced=True)
    B, S = WHISPER_PARITY["batch"], WHISPER_PARITY["seq"]
    n = WHISPER_PARITY["steps"]
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32,
                 ce_chunk=min(S, 512), remat_policy="none")
    hyper = TrainHyper(opt=AdamWConfig(lr=3e-3, warmup_steps=2,
                                       total_steps=n))
    state_gpu = init_train_state(torch.Generator(device=dev).manual_seed(0),
                                 cfg, rt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=1234))
    step = make_train_step(cfg, rt, hyper)
    _reset(flash_ops.launches)
    bad = []
    for s in range(n):
        batch = dict(data.batch_at(s), frames=train.frames_at(1234, s, B,
                                                              cfg))
        cpu_batch = {k: torch.as_tensor(a) for k, a in batch.items()}
        state_cpu = _copy_to(state_gpu, torch.device("cpu"))
        state_cpu, m_cpu = step(state_cpu, cpu_batch)
        state_gpu, m_gpu = step(state_gpu, {
            k: torch.as_tensor(a, device=dev) for k, a in batch.items()})
        row = _step_rows(s, m_gpu, m_cpu, state_gpu, state_cpu, bad)
        log(f"[whisper-parity] step {s}: " + ", ".join(row))
    per = flash_per_prefill(cfg) * n
    counts = dict(flash_ops.launches)
    log(f"[whisper-parity] reduced {cfg.name} fp32 B={B} S={S} frames="
        f"{cfg.encoder_seq}, {n} steps: outside tolerance {bad}, launches "
        f"{counts}")
    if bad:
        raise AssertionError("card and CPU training disagree")
    if counts != {"flash_attention": per, "flash_attention_bwd": per}:
        raise AssertionError("the card's steps missed a flash launch")
    del state_gpu
    torch.cuda.empty_cache()
    serve_parity_path(dev, WHISPER_SERVE_PARITY)


# --------------------------------------------------------------------------- #
# serving (phases 8-9)
# --------------------------------------------------------------------------- #
# (arch, batch, prompt length, generated tokens), bf16, full width and depth
SERVE = [("smollm-135m", 8, 1024, 32), ("smollm-135m", 8, 1000, 32),
         ("phi3-mini-3.8b", 4, 2048, 32)]
# fp32 card-vs-CPU parity: logits within LOGIT_TOL, absolute, on logits of
# scale ~4: 30 layers of fp32 sums in cuBLAS's, the kernel's and the CPU's
# orders move a logit by ~1e-5 of its scale; greedy tokens equal unless
# the CPU's top-2 gap is below NEAR_TIE_LOGIT
PARITY = dict(arch="smollm-135m", B=2, P=128, gen=8)
LOGIT_TOL = 1e-4
NEAR_TIE_LOGIT = 2 * LOGIT_TOL


def serve_path(dev):
    """Phase 8: serve each ``SERVE`` entry through ``launch.serve.run`` in
    bf16 at full width and depth.  The flash counter is set to 0 just
    before each run and read just after: one launch per layer in prefill,
    none in decode.  Returns the launches of all runs."""
    total = 0
    for arch, B, P, gen in SERVE:
        n_layers = get_config(arch).n_layers
        args = serve.make_parser().parse_args(
            ["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
             "--gen", str(gen)])
        torch.cuda.reset_peak_memory_stats(dev)
        flash_ops.launches["flash_attention"] = 0
        r = serve.run(args)
        n = flash_ops.launches["flash_attention"]
        mem = torch.cuda.max_memory_allocated(dev)
        log(f"[serve] {arch} bf16 B={B} prompt={P} gen={gen}: prefill "
            f"{r['prefill_s'] * 1e3:.2f} ms ({B * P / r['prefill_s']:.0f} "
            f"prompt tokens/s), decode {r['decode_s'] * 1e3:.2f} ms for "
            f"{gen - 1} steps ({r['decode_tok_s']:.1f} tokens/s), peak "
            f"memory {mem / 2**30:.2f} GiB, flash launches prefill "
            f"{r['flash_launches']['prefill']} decode "
            f"{r['flash_launches']['decode']} (layers {n_layers}), "
            f"generated {r['generated_shape']}, sample {r['sample']}")
        if r["flash_launches"] != {"prefill": n_layers, "decode": 0} or \
                n != n_layers:
            raise AssertionError(f"{arch}: {n} flash launches, expected one "
                                 f"per layer ({n_layers}) in prefill only")
        if not r["logits_finite"] or r["generated_shape"] != [B, gen]:
            raise AssertionError(f"{arch}: non-finite logits or wrong shape")
        total += n
    return total


def _greedy(params, tokens, cfg, rt, steps, forced=None, frames=None):
    """Prefill (over whisper's ``frames`` where given), then ``steps``
    greedy decode steps; feeds ``forced`` (B, steps) tokens instead of its
    own picks where given.  Returns the logits (steps + 1, B, V) as
    float64 numpy and the picks (steps + 1, B)."""
    B, P = tokens.shape
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = frames
    logits, cache = forward_prefill(params, batch, cfg, rt,
                                    cache_size=P + steps)
    out = [logits]
    for i in range(steps):
        tok = logits.argmax(-1) if forced is None else forced[:, i]
        logits, cache = forward_decode(params, tok.int()[:, None], cache,
                                       P + i, cfg, rt)
        out.append(logits)
    lg = torch.stack(out).double().cpu().numpy()[..., :cfg.vocab_size]
    return lg, lg.argmax(-1)


def serve_parity_path(dev, spec=PARITY):
    """Phase 9 (and the second half of phases 15 and 18): an fp32 config
    (``spec``: smollm-135m at full width and depth, the reduced jamba, or
    whisper at full width cut to ``spec["layers"]`` + ``spec["layers"]``
    layers over stub frames) from the same generator-made parameters on the
    card and on the CPU plain path.  The CPU decodes greedily; the card is
    fed the CPU's picks, so both compute on the same tokens at every step.
    The card's prefill launches the flash kernel once per attention layer
    (``flash_per_prefill``) and the scan kernel once per Mamba layer.
    Logits must agree within LOGIT_TOL and the card's picks equal the
    CPU's except on near-ties."""
    cfg = (whisper_cut(spec["layers"]) if "layers" in spec else
           get_config(spec["arch"], reduced=spec.get("reduced", False)))
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, rt)
    params_cpu = _copy_to(params, torch.device("cpu"))
    B, P, steps = spec["B"], spec["P"], spec["gen"] - 1
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P), dtype=np.int32))
    frames = (torch.as_tensor(np.random.default_rng(1).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model), dtype=np.float32))
        if cfg.encoder_layers else None)
    t0 = time.perf_counter()
    lg_cpu, pick_cpu = _greedy(params_cpu, tokens, cfg, rt, steps,
                               frames=frames)
    t_cpu = time.perf_counter() - t0
    _reset(flash_ops.launches, ssm_ops.launches)
    lg_gpu, pick_gpu = _greedy(
        params, tokens.to(dev), cfg, rt, steps,
        forced=torch.as_tensor(pick_cpu[:steps].T, device=dev),
        frames=None if frames is None else frames.to(dev))
    if flash_ops.launches["flash_attention"] != flash_per_prefill(cfg) or \
            ssm_ops.launches["ssm_scan"] != _mixers(cfg, "mamba"):
        raise AssertionError("the card's prefill missed a kernel")
    err = float(np.abs(lg_gpu - lg_cpu).max())
    top2 = np.sort(lg_cpu, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    differ = pick_gpu != pick_cpu
    ties = int((differ & (gap < NEAR_TIE_LOGIT)).sum())
    bad = int((differ & (gap >= NEAR_TIE_LOGIT)).sum())
    log(f"[serve-parity] {cfg.name} fp32 B={B} prompt={P} "
        f"steps={steps + 1}: max |logit| {np.abs(lg_cpu).max():.3f}, max "
        f"card-vs-cpu logit error {err:.3e} (tol {LOGIT_TOL:.0e}), picks "
        f"{int((~differ).sum())}/{differ.size} equal, near-ties {ties}, "
        f"disagreements {bad}, smallest top-2 gap {gap.min():.3e}; CPU "
        f"path {t_cpu:.1f} s")
    if err > LOGIT_TOL or bad:
        raise AssertionError("card and CPU disagree beyond tolerance")


# --------------------------------------------------------------------------- #
# phases 3-7
# --------------------------------------------------------------------------- #
def seeded_fleet(device, seed=0, **bank_kw):
    bank = StudyBank(hartmann_space(), FLEET["B"], seed=seed, device=device,
                     **bank_kw)
    rng = np.random.default_rng(seed + 1000)
    for b in range(FLEET["B"]):
        v = bank.study(b)
        for _ in range(FLEET["n_obs"]):
            p = {f"x{i}": float(x) for i, x in enumerate(rng.uniform(size=6))}
            v.observe_params(p, neg_hartmann6(p))
    return bank


def check_picks(trials, n):
    for b, ts in enumerate(trials):
        assert len(ts) == n, (b, len(ts))
        rows = [tuple(t.params[f"x{i}"] for i in range(6)) for t in ts]
        assert len(set(rows)) == n, f"study {b}: repeated pick"
        for r in rows:
            assert all(0.0 <= x <= 1.0 and math.isfinite(x) for x in r), r


def pick_launches(launches) -> dict:
    """The pick kernels' counts of ``ops.launches`` (the fit's kernels,
    ``masked_kernel`` and ``fit_grad``, launch once per Adam step of
    every refit, ``masked_kernel`` once more per factors build; phase 3
    checks them)."""
    return {k: launches[k] for k in ("score_cov", "var_downdate")}


def fleet_path(dev):
    """Phase 3; returns the bank and the launch counts of its asks."""
    bank = seeded_fleet(dev)
    n = FLEET["batch"]
    log(f"[fleet] {FLEET['B']} studies x {FLEET['n_obs']} observations, "
        f"mc_samples={bank.space.mc_samples(n)} per study, batch {n}")
    torch.cuda.reset_peak_memory_stats()
    for k in ops.launches:
        ops.launches[k] = 0
    for rnd in range(FLEET["rounds"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trials = bank.ask_all(n)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_picks(trials, n)
        for b, ts in enumerate(trials):
            for t in ts:
                bank.tell(b, t.id, neg_hartmann6(t.params))
        best = max(max(t.value for t in v.observed_trials())
                   for v in bank.studies)
        log(f"[fleet] round {rnd}: ask_all({n}) {dt * 1e3:.1f} ms "
            f"(host clock, synchronized), best -Hartmann6 so far "
            f"{best:.5f}")
    launches = dict(ops.launches)
    log(f"[fleet] launches {launches}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if launches["score_cov"] < FLEET["rounds"] or \
            launches["var_downdate"] < FLEET["rounds"] * (n - 1) or \
            launches["fit_grad"] < bank.fit_steps or \
            not 1 <= launches["masked_kernel"] - launches["fit_grad"] \
            <= FLEET["rounds"]:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    return bank, launches


def tuner_path(dev):
    """Phase 4: the paper's Fig. 3 setting on the card."""
    for k in ops.launches:
        ops.launches[k] = 0
    tuner = Tuner(branin_space(), lambda p: modified_branin(p),
                  dict(batch_size=5, num_iteration=15, seed=3,
                       scheduler=SerialScheduler(), device=dev))
    t0 = time.perf_counter()
    res = tuner.minimize()
    torch.cuda.synchronize()
    log(f"[tuner] mixed Branin, batch 5 x 15 iterations: best "
        f"{res.best_objective:.5f} at {res.best_params} "
        f"({time.perf_counter() - t0:.2f} s, launches {dict(ops.launches)})")
    assert math.isfinite(res.best_objective)
    assert len(res.params_tried) == 2 + 5 * 15, len(res.params_tried)
    if ops.launches["score_cov"] < 1 or ops.launches["var_downdate"] < 1:
        raise AssertionError(f"Tuner skipped a kernel: {ops.launches}")


def _reset(*counters):
    for c in counters:
        for k in c:
            c[k] = 0


def _timed_ask(bank, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trials = bank.ask_all(n)
    torch.cuda.synchronize()
    return trials, (time.perf_counter() - t0) * 1e3


def _tell_all(bank, trials):
    for b, ts in enumerate(trials):
        for t in ts:
            bank.tell(b, t.id, neg_hartmann6(t.params))


def tpe_fleet_path(dev):
    """Phase 4: the 64-study TPE fleet, three rounds of ask_all(4) -> tell;
    then a fleet with ``pending_penalty=True`` that asks with a batch in
    flight.  ``tpe_scores`` launches once per ask.  Returns the pending
    bank (a batch still in flight) and the launch count."""
    n = FLEET["batch"]
    bank = seeded_fleet(dev, optimizer="tpe")
    pend = seeded_fleet(dev, seed=1, optimizer="tpe",
                        strategy_kwargs={"pending_penalty": True})
    log(f"[tpe] {FLEET['B']} TPE studies x {FLEET['n_obs']} observations, "
        f"mc_samples={bank.space.mc_samples(n)} per study, batch {n}")
    _reset(tpe_ops.launches)
    asks = 0
    for rnd in range(FLEET["rounds"]):
        trials, ms = _timed_ask(bank, n)
        asks += 1
        check_picks(trials, n)
        _tell_all(bank, trials)
        best = max(max(t.value for t in v.observed_trials())
                   for v in bank.studies)
        log(f"[tpe] round {rnd}: ask_all({n}) {ms:.1f} ms (host clock, "
            f"synchronized), best -Hartmann6 so far {best:.5f}")
    first, ms0 = _timed_ask(pend, n)            # left in flight
    trials, ms1 = _timed_ask(pend, n)           # asks with 4 rows in flight
    asks += 2
    check_picks(trials, n)
    for b in range(FLEET["B"]):
        held = {tuple(t.params.values()) for t in first[b]}
        assert not held & {tuple(t.params.values()) for t in trials[b]}
    _tell_all(pend, trials)
    log(f"[tpe] pending_penalty: ask_all({n}) {ms0:.1f} ms with nothing in "
        f"flight, {ms1:.1f} ms with {n} trials per study in flight "
        "(absorbed into the bad split)")
    launches = tpe_ops.launches["tpe_scores"]
    log(f"[tpe] asks {asks}, tpe_scores launches {launches}")
    if launches != asks:
        raise AssertionError(f"tpe_scores launched {launches} times in "
                             f"{asks} TPE asks")
    return pend, launches


def parzen_path(dev):
    """The entry point of ``parzen_logdens``, ``tpe_kde.ops.parzen_logdens``
    (off the ask path): three studies' 200 observations scoring 16,800
    candidates each on the card, held against the host oracle
    ``TPEStrategy._log_kde``.  Returns the launch count."""
    from repro_torch.core.tpe import TPEStrategy
    rng = np.random.default_rng(5)
    _reset(tpe_ops.launches)
    worst = 0.0
    for _ in range(3):
        pts = rng.uniform(size=(FLEET["n_obs"], 6)).astype(np.float32)
        cands = rng.uniform(size=(16800, 6)).astype(np.float32)
        got = tpe_ops.parzen_logdens(cands, pts, device=dev)
        want = TPEStrategy._log_kde(pts, cands)
        assert got.shape == (16800,) and np.isfinite(got).all()
        worst = max(worst, float(np.abs(got - want).max()))
    launches = tpe_ops.launches["parzen_logdens"]
    log(f"[parzen] ops.parzen_logdens x3 (16,800 x 200 x 6) vs the numpy "
        f"host oracle: max_abs_err {worst:.3e} (tol {TPE_TOL:.0e}), "
        f"launches {launches}")
    if worst > TPE_TOL or launches != 3:
        raise AssertionError(f"parzen path: err {worst}, launches "
                             f"{launches}")
    return launches


def mixed_fleet_path(dev):
    """Phase 5: 32 bayesian and 32 tpe studies in one bank, one round; each
    family launches its kernels."""
    n = FLEET["batch"]
    half = FLEET["B"] // 2
    bank = seeded_fleet(dev, seed=2,
                        optimizer=["bayesian"] * half + ["tpe"] * half)
    _reset(ops.launches, tpe_ops.launches)
    trials, ms = _timed_ask(bank, n)
    check_picks(trials, n)
    _tell_all(bank, trials)
    got = {**ops.launches, **tpe_ops.launches}
    log(f"[mixed] {half} bayesian + {half} tpe studies: ask_all({n}) "
        f"{ms:.1f} ms (host clock, synchronized), launches {got}")
    if got["score_cov"] != 1 or got["var_downdate"] != n - 1 or \
            got["tpe_scores"] != 1:
        raise AssertionError(f"mixed fleet skipped a family: {got}")


def fig3_tpe_path(dev):
    """Phase 6, TPE: the Fig. 3 mixed Branin through ``Tuner`` serial
    (batch 1 x 20) and parallel (batch 5 x 15), and through ``AsyncTuner``
    over ``SerialScheduler().as_async(coalesce=True)`` for 40 evaluations
    (one dispatcher thread completes trials in submit order and one trial
    is in flight after the first two, so the run is deterministic); every
    best value equals the CPU port's."""
    runs = {
        "tuner serial": lambda d: Tuner(
            branin_space(), modified_branin,
            dict(optimizer="tpe", batch_size=1, num_iteration=20, seed=3,
                 scheduler=SerialScheduler(), device=d)).minimize(),
        "tuner parallel": lambda d: Tuner(
            branin_space(), modified_branin,
            dict(optimizer="tpe", batch_size=5, num_iteration=15, seed=3,
                 scheduler=SerialScheduler(), device=d)).minimize(),
        "async": lambda d: AsyncTuner(
            branin_space(), modified_branin,
            SerialScheduler().as_async(coalesce=True), optimizer="tpe",
            num_evals=40, batch_size=1, initial_random=2, seed=3,
            device=d).minimize(),
    }
    want_asks = {"tuner serial": 20, "tuner parallel": 15, "async": 38}
    for tag, run in runs.items():
        _reset(tpe_ops.launches)
        t0 = time.perf_counter()
        res = run(dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = tpe_ops.launches["tpe_scores"]
        ref_res = run("cpu")
        same = res.params_tried == ref_res.params_tried
        log(f"[fig3-tpe] {tag}: best {res.best_objective:.5f} on the card, "
            f"{ref_res.best_objective:.5f} on the CPU; params_tried "
            f"{'identical' if same else 'differ'}; {wall:.2f} s, "
            f"tpe_scores launches {launches}")
        assert math.isfinite(res.best_objective)
        if res.best_objective != ref_res.best_objective:
            raise AssertionError(f"{tag}: best value differs from the CPU")
        if launches != want_asks[tag]:
            raise AssertionError(f"{tag}: {launches} launches for "
                                 f"{want_asks[tag]} TPE asks")


def gp_oracle(bank, led, C, in_flight, b):
    """``picks_agree`` oracle of study b's GP-BUCB slots (float64)."""
    ids = led.obs_ids(b)
    X = led.X[b, ids]
    z = (led.y[b, ids].astype(np.float32) - led.y_mean[b]) / led.y_std[b]
    hyp = (np.exp(led.log_ls[b]), np.exp(led.log_var[b]),
           np.exp(led.log_noise[b]) + 1e-5)
    return lambda prev: bucb_acquisition(X, z, C[b], *hyp, prev,
                                         bank.study(b).domain_size,
                                         in_flight[b])


def tpe_oracle(bank, led, C, in_flight, b):
    """``picks_agree`` oracle of study b's TPE top-b (float64 score)."""
    ids = led.obs_ids(b)
    return top_b_oracle(tpe_score64(
        led.X[b, ids], led.y[b, ids], C[b],
        bank.strategy_kwargs.get("gamma", 0.25), in_flight[b]))


def oracle_judge(oracle_for):
    """A ``parity_path`` judge from a ``picks_agree`` oracle maker."""
    def judge(bank, led, C, in_flight, b, ig, ic):
        ok, slot = picks_agree(ig, ic, oracle_for(bank, led, C, in_flight,
                                                  b))
        return ok, f"from slot {slot}", None, []
    return judge


def cluster_judge(bank, led, C, in_flight, b, ig, ic):
    """``parity_path`` judge of a clustering study: the float64 replay of
    its pick (``cluster_replay``) on the float64 surface with its in-flight
    trials absorbed, from the k-means uniforms of the ask (seeded by the
    ask count before it; ``led`` is read after the ask).  A near-tie
    (``CLUSTER_TIES``) excuses the difference."""
    from repro_torch.core.kmeans import kmeans_uniforms
    from repro_torch.core.strategies import n_top_candidates
    ids = led.obs_ids(b)
    z = (led.y[b, ids].astype(np.float32) - led.y_mean[b]) / led.y_std[b]
    acq = bucb_acquisition(led.X[b, ids], z, C[b], np.exp(led.log_ls[b]),
                           np.exp(led.log_var[b]),
                           np.exp(led.log_noise[b]) + 1e-5, [],
                           bank.study(b).domain_size, in_flight[b])
    n = len(ig)
    u = kmeans_uniforms(led.ask_count[[b]] - 1, n)[0]
    n_top = n_top_candidates(C.shape[1], n,
                             bank.strategy_kwargs.get("top_frac", 0.2))
    picks, m = cluster_replay(acq, C[b], n, n_top, u)
    return cluster_near_tie(m), (
        "float64 replay " + str(picks) + ", margins "
        + ", ".join(f"{k} {v:.2e} (tol {CLUSTER_TIES[k]:.0e})"
                    for k, v in m.items())), picks, [
        k for k, tol in CLUSTER_TIES.items() if m[k] <= tol]


def parity_path(bank, tag, judge, taken_in_by, audit=False):
    """Phase 7 (and 19): the same fleet ask from one state on the card and
    on the CPU, each taking in the same batch of in-flight trials
    (``taken_in_by``); picks must agree except on near-ties, judged by
    ``judge(bank, ledger, C, in_flight, b, card picks, cpu picks)`` ->
    (near-tie, what it saw, the replay's picks or None, the kinds of
    margin under their tolerance).  With ``audit``
    the judge also replays every study whose picks agree, and the phase
    prints how many replays see a near-tie and how many of the others
    pick as the CPU did."""
    n = FLEET["batch"]
    bank.ask_all(n)     # left in flight: the compared ask takes them in
    path = ROOT / "build" / f"chip_smoke_{tag}_fleet.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    bank.save(path)
    cpu = StudyBank(hartmann_space(), FLEET["B"],
                    strategy_kwargs=bank.strategy_kwargs, device="cpu")
    cpu.load(path)      # restores every study's strategy too
    led = cpu.ledger
    in_flight = [led.X[b, led.pending_ids(b)] for b in range(FLEET["B"])]
    state = bank._rng.bit_generator.state
    got_gpu, ms = _timed_ask(bank, n)
    t0 = time.perf_counter()
    got_cpu = cpu.ask_all(n)
    log(f"[{tag}-parity] card ask with {n} trials per study in flight "
        f"({taken_in_by}): {ms:.1f} ms; CPU ask of the same state: "
        f"{time.perf_counter() - t0:.2f} s")
    # replay the candidate draw both banks saw
    replay = np.random.default_rng(0)
    replay.bit_generator.state = state
    n_mc = bank.mc_samples or bank.space.mc_samples(n)
    cols = bank.space.sample_columns(FLEET["B"] * n_mc, replay)
    C = bank.space.encode_columns(cols, FLEET["B"] * n_mc).reshape(
        FLEET["B"], n_mc, -1)
    bad, ties = 0, 0
    tied, clean, faithful = 0, 0, 0
    binding = {}
    for b in range(FLEET["B"]):
        ig, ic = ([int(np.flatnonzero((C[b] == r).all(1))[0])
                   for r in bank.space.encode([t.params for t in got[b]])]
                  for got in (got_gpu, got_cpu))
        if ig == ic:
            if audit:
                tie, _, replay, kinds = judge(bank, led, C, in_flight, b, ig,
                                              ic)
                tied += tie
                clean += not tie
                faithful += (not tie) and replay == ic
                for k in kinds:
                    binding[k] = binding.get(k, 0) + 1
            continue
        ok, where = judge(bank, led, C, in_flight, b, ig, ic)[:2]
        ties += ok
        bad += not ok
        log(f"[{tag}-parity] study {b}: picks differ "
            f"({'near-tie' if ok else 'DISAGREE'}): cuda {ig} cpu {ic}; "
            f"{where}")
    log(f"[{tag}-parity] studies checked {FLEET['B']}, near-ties {ties}, "
        f"disagreements {bad}")
    if audit:
        log(f"[{tag}-parity] audit of the {tied + clean} studies whose "
            f"picks agree: the float64 replay sees a near-tie in {tied} "
            f"(studies under each margin's tolerance: {binding}); of the "
            f"other {clean}, it picks as the CPU did in {faithful}")
    if bad:
        raise AssertionError(f"{bad} {tag} studies disagree beyond "
                             "near-ties")


def cluster_head_parity(bank, dev):
    """Phase 19: the clustering head alone (``gp.cluster_pick``: top set,
    k-means, one pick a cluster) on the card and on the CPU from the same
    float32 surfaces: each fleet study's float64 UCB surface
    (``bucb_acquisition`` of its observations) over a fresh candidate draw,
    rounded to float32, with the k-means uniforms of its next ask.  Picks
    must be equal but at a float32-order near-tie (``HEAD_TIES``) of the
    float64 replay on that surface.  Also times the head on the card."""
    from repro_torch.core.kmeans import kmeans_uniforms
    from repro_torch.core.strategies import n_top_candidates
    n, B = FLEET["batch"], FLEET["B"]
    led = bank.ledger
    n_mc = bank.space.mc_samples(n)
    cols = bank.space.sample_columns(B * n_mc, np.random.default_rng(11))
    C = bank.space.encode_columns(cols, B * n_mc).reshape(
        B, n_mc, -1).astype(np.float32)
    acq = np.empty((B, n_mc), np.float32)
    for b in range(B):
        ids = led.obs_ids(b)
        z = (led.y[b, ids].astype(np.float32) - led.y_mean[b]) / led.y_std[b]
        acq[b] = bucb_acquisition(
            led.X[b, ids], z, C[b], np.exp(led.log_ls[b]),
            np.exp(led.log_var[b]), np.exp(led.log_noise[b]) + 1e-5, [],
            bank.study(b).domain_size)
    u = kmeans_uniforms(led.ask_count, n)
    n_top = n_top_candidates(n_mc, n, 0.2)

    def args(d):
        return [torch.as_tensor(a, device=d) for a in (acq, C, u)]

    card_args = args(dev)
    got = gp_lib.cluster_pick(*card_args, n_top, n).cpu().numpy()
    want = gp_lib.cluster_pick(*args("cpu"), n_top, n).numpy()
    ms = cuda_ms(lambda: gp_lib.cluster_pick(*card_args, n_top, n), 5)
    ties = bad = 0
    for b in np.nonzero((got != want).any(1))[0]:
        _, m = cluster_replay(acq[b], C[b], n, n_top, u[b])
        ok = cluster_near_tie(m, HEAD_TIES)
        ties += ok
        bad += not ok
        log(f"[cluster-head] study {b}: picks differ "
            f"({'near-tie' if ok else 'DISAGREE'}): cuda {got[b].tolist()} "
            f"cpu {want[b].tolist()}; margins " + ", ".join(
                f"{k} {v:.2e}" for k, v in m.items()))
    log(f"[cluster-head] {B} studies, top set {n_top} of {n_mc}, "
        f"{n} clusters: picks equal in {B - ties - bad}, near-ties {ties}, "
        f"disagreements {bad}; the head on the card {ms:.3f} ms (CUDA "
        "events, top set, k-means and picks for the whole fleet)")
    if bad:
        raise AssertionError(f"{bad} studies' cluster heads disagree")


def cluster_fleet_path(dev):
    """Phase 19: the phase-3 fleet with ``optimizer="clustering"``, three
    rounds of ask_all(4) -> tell, ``score_cov`` launching once per ask and
    no GP-BUCB downdate; a mixed fleet of 22 GP, 21 TPE and 21 clustering
    studies, one round, where every family's kernels launch (``score_cov``
    once for the GP rows and once for the clustering rows); the
    card-vs-CPU pick parity of phase 7 on the clustering fleet; and the
    Fig. 3 mixed Branin through ``Tuner(optimizer="clustering")``, batch 5,
    judged as phase 6 judges GP-BUCB.  Returns the fleet's score_cov
    launches."""
    n = FLEET["batch"]
    bank = seeded_fleet(dev, seed=3, optimizer="clustering")
    log(f"[cluster] {FLEET['B']} clustering studies x {FLEET['n_obs']} "
        f"observations, mc_samples={bank.space.mc_samples(n)} per study, "
        f"batch {n}, top set "
        f"{max(4 * n, int(bank.space.mc_samples(n) * 0.2))}")
    _reset(ops.launches)
    for rnd in range(FLEET["rounds"]):
        trials, ms = _timed_ask(bank, n)
        check_picks(trials, n)
        _tell_all(bank, trials)
        best = max(max(t.value for t in v.observed_trials())
                   for v in bank.studies)
        log(f"[cluster] round {rnd}: ask_all({n}) {ms:.1f} ms (host clock, "
            f"synchronized), best -Hartmann6 so far {best:.5f}")
    launches = dict(ops.launches)
    log(f"[cluster] launches {launches}")
    if pick_launches(launches) != {"score_cov": FLEET["rounds"],
                                   "var_downdate": 0}:
        raise AssertionError(f"clustering asks launched {launches}")
    third = FLEET["B"] // 3
    counts = (FLEET["B"] - 2 * third, third, third)    # 22, 21, 21
    names = sum(([nm] * c for nm, c in zip(
        ("bayesian", "tpe", "clustering"), counts)), [])
    mixed = seeded_fleet(dev, seed=4, optimizer=names)
    _reset(ops.launches, tpe_ops.launches)
    trials, ms = _timed_ask(mixed, n)
    check_picks(trials, n)
    got = {**pick_launches(ops.launches), **tpe_ops.launches}
    log(f"[cluster-mixed] {counts[0]} bayesian + {counts[1]} tpe + "
        f"{counts[2]} clustering studies: ask_all({n}) {ms:.1f} ms (host "
        f"clock, synchronized), launches {got}")
    if got != {"score_cov": 2, "var_downdate": n - 1, "tpe_scores": 1,
               "parzen_logdens": 0}:
        raise AssertionError(f"mixed fleet skipped a family: {got}")
    del mixed
    parity_path(bank, "cluster", cluster_judge, "bank_absorb", audit=True)
    cluster_head_parity(bank, dev)
    _reset(ops.launches)
    tuner = Tuner(branin_space(), modified_branin,
                  dict(optimizer="clustering", batch_size=5,
                       num_iteration=15, seed=3,
                       scheduler=SerialScheduler(), device=dev))
    t0 = time.perf_counter()
    res = tuner.minimize()
    torch.cuda.synchronize()
    log(f"[cluster-tuner] mixed Branin, clustering batch 5 x 15 "
        f"iterations: best {res.best_objective:.5f} at {res.best_params} "
        f"({time.perf_counter() - t0:.2f} s, launches {dict(ops.launches)})")
    assert math.isfinite(res.best_objective)
    assert len(res.params_tried) == 2 + 5 * 15, len(res.params_tried)
    if ops.launches["score_cov"] < 1 or ops.launches["var_downdate"]:
        raise AssertionError(f"clustering Tuner launches {ops.launches}")
    return launches["score_cov"]

# --------------------------------------------------------------------------- #
# phase 20: the fault-tolerant schedulers and the durable service
# --------------------------------------------------------------------------- #
SERVICE = dict(B=64, n_obs=40, batch=4, rounds=3)
SERVICE_FAMILIES = (("bayesian", 22), ("tpe", 21), ("clustering", 21))
QUEUE_FAULTS = dict(failure_rate=0.2, straggler_rate=0.1,
                    straggler_delay=0.05, seed=0)


def card_branin(p: dict) -> float:
    """Phase 20a's trial, run in a worker process: the mixed Branin of
    phase 6 computed on the card in float64."""
    x = torch.tensor([p["x1"], float(p["x2"])], dtype=torch.float64,
                     device="cuda")
    a, b, c = 1.0, 5.1 / (4 * math.pi ** 2), 5 / math.pi
    r, s, t = 6.0, 10.0, 1 / (8 * math.pi)
    v = (a * (x[1] - b * x[0] ** 2 + c * x[0] - r) ** 2
         + s * (1 - t) * torch.cos(x[0]) + s)
    return float(v.item()) + {"low": 0.0, "high": 12.0}[p["mode"]]


def _worker_pid(_):
    return os.getpid()


def pool_start_s(method: str, n_workers: int = 2) -> float:
    """Seconds to start a pool of ``n_workers`` processes by ``method``,
    run one no-op task on each and shut the pool down."""
    ctx = multiprocessing.get_context(method)
    t0 = time.perf_counter()
    with cf.ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx) as ex:
        list(ex.map(_worker_pid, range(n_workers)))
    return time.perf_counter() - t0


def process_scheduler_path(dev):
    """Phase 20a: ``Tuner`` (GP, batch 5, 3 iterations) on the mixed
    Branin through ``ProcessScheduler``'s batch objective while this
    process holds a CUDA context; every trial computes on the card in a
    worker process.  Logs each batch's wall and the start cost of a
    two-worker pool by spawn and by forkserver."""
    torch.zeros(1, device=dev)                  # this process holds a context
    sched = ProcessScheduler(n_workers=2)
    batch_objective = sched.make_objective(card_branin)
    walls = []

    def timed(params_list):
        t0 = time.perf_counter()
        out = batch_objective(params_list)
        walls.append(time.perf_counter() - t0)
        return out

    res = Tuner(branin_space(), timed,
                dict(batch_size=5, num_iteration=3, seed=3,
                     device=dev)).minimize()
    assert res.n_failed == 0, res.n_failed
    assert len(res.params_tried) == 2 + 5 * 3, len(res.params_tried)
    worst = max(abs(v - modified_branin(p))
                for p, v in zip(res.params_tried, res.objective_values))
    starts = {m: pool_start_s(m) for m in ("spawn", "forkserver")}
    starts["forkserver again"] = pool_start_s("forkserver")
    log(f"[process] Tuner GP batch 5 x 3 through ProcessScheduler(2) "
        f"(spawned workers): {len(walls)} batches, wall per batch "
        + ", ".join(f"{w:.3f}" for w in walls) + " s (mean "
        f"{sum(walls) / len(walls):.3f} s); card objective vs host: max "
        f"abs diff {worst:.3e}; best {res.best_objective:.5f}")
    log("[process] a two-worker pool's start (2 no-op tasks, shutdown): "
        + ", ".join(f"{m} {v:.3f} s" for m, v in starts.items()))
    if worst > 1e-9:
        raise AssertionError(f"card objective differs by {worst}")


def _fault_queue_run(kind, dev):
    """One driver run over a fault-injecting task queue; returns the
    results, the submit sequence numbers that were dropped and the count
    of submits."""
    sched = TaskQueueScheduler(n_workers=4,
                               faults=FaultInjection(**QUEUE_FAULTS))
    handles = []
    submit = sched.submit

    def recording(fn, params):     # submits come from one thread, in order
        h = submit(fn, params)
        handles.append(h)
        return h

    sched.submit = recording
    if kind == "tuner":
        res = Tuner(branin_space(), modified_branin,
                    dict(batch_size=5, num_iteration=6, seed=3,
                         scheduler=sched, device=dev)).minimize()
    else:
        res = AsyncTuner(branin_space(), modified_branin, sched,
                         optimizer="tpe", num_evals=30, batch_size=4,
                         initial_random=2, seed=3, device=dev).minimize()
    if not sched.shutdown(timeout=30.0):
        raise AssertionError("task queue did not drain")
    dropped = [i for i, h in enumerate(handles) if h.error is not None]
    return res, dropped, len(handles), dict(sched.stats)


def fault_queue_path(dev):
    """Phase 20b: ``Tuner`` (GP, batch 5) and ``AsyncTuner`` (TPE) over
    ``TaskQueueScheduler`` with injected failures and stragglers, on the
    card and on the CPU port: the dropped submit sequence numbers are a
    pure function of the seed, so they must be equal."""
    for kind in ("tuner", "async"):
        t0 = time.perf_counter()
        res, dropped, n, stats = _fault_queue_run(kind, dev)
        wall = time.perf_counter() - t0
        _, cpu_dropped, cpu_n, _ = _fault_queue_run(kind, "cpu")
        log(f"[faults] {kind}: {n} submits, dropped seqs {dropped} (CPU "
            f"port: {cpu_dropped} of {cpu_n}), stats {stats}, "
            f"n_failed {res.n_failed}, best {res.best_objective:.5f}, "
            f"{wall:.2f} s on the card")
        if (dropped, n) != (cpu_dropped, cpu_n) or not dropped:
            raise AssertionError(f"{kind}: dropped set differs from the "
                                 "CPU port's or is empty")
        if res.n_failed != len(dropped):
            raise AssertionError(f"{kind}: {res.n_failed} failed trials "
                                 f"for {len(dropped)} dropped")


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def service_config():
    return {"space": {f"x{i}": {"uniform": [0.0, 1.0]} for i in range(6)},
            "max_studies": SERVICE["B"], "optimizer": "bayesian",
            "seed": 0}


def service_studies():
    names = sum(([nm] * c for nm, c in SERVICE_FAMILIES), [])
    return [(f"s{b:02d}", nm) for b, nm in enumerate(names)]


def service_fill(ex):
    """Create phase 20c's studies and give each ``n_obs`` observations
    (one journaled op each), then compact."""
    rng = np.random.default_rng(20)
    for name, nm in service_studies():
        ex.create_study(name, optimizer=nm)
    for name, _ in service_studies():
        for _ in range(SERVICE["n_obs"]):
            p = {f"x{i}": float(x) for i, x in enumerate(rng.uniform(size=6))}
            ex.observe(name, p, neg_hartmann6(p))


def service_round(ex, rnd, lat=None):
    """One round: ask(batch) -> tell for every study.  ``lat`` collects
    (family, seconds) of each ask."""
    for name, nm in service_studies():
        t0 = time.perf_counter()
        trials = ex.ask(name, SERVICE["batch"], req_id=f"r{rnd}{name}")
        if lat is not None:
            lat.append((nm, time.perf_counter() - t0))
        rows = trials["trials"]
        assert len(rows) == SERVICE["batch"] and not trials["cached"]
        for t in rows:
            assert all(0.0 <= v <= 1.0 for v in t["params"].values()), t
            ex.tell(name, t["id"], neg_hartmann6(t["params"]))


def service_path(dev):
    """Phase 20c: the service at a fleet's size over HTTP on the card (64
    studies: 22 bayesian, 21 tpe, 21 clustering, Hartmann-6, the default
    candidate budget); 40 observations each through ``observe``, one
    compaction, then 3 rounds of ask(4) -> tell per study through
    ``ServiceClient``.  The service is then closed and restarted on its
    data dir (snapshot + WAL suffix); every study's trials must be
    JSON-equal to an uninterrupted twin's, and the next ask(4) of one study
    per family bit-equal.  Returns the rounds' kernel launches."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        httpd, svc = serve_service(os.path.join(tmp, "svc"), port=0,
                                   config=service_config(), device=dev)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        journal, bank_ask = [], []
        append, apply_op = svc.wal.append, svc.bank.apply_op

        def timed_append(record, mid_hook=None):
            t0 = time.perf_counter()
            append(record, mid_hook=mid_hook)
            journal.append(time.perf_counter() - t0)

        def timed_apply(op):
            t0 = time.perf_counter()
            out = apply_op(op)
            if op["op"] == "ask":
                bank_ask.append(time.perf_counter() - t0)
            return out

        svc.wal.append, svc.bank.apply_op = timed_append, timed_apply
        client = ServiceClient(
            f"http://127.0.0.1:{httpd.server_address[1]}", timeout=120.0,
            retries=0)
        t0 = time.perf_counter()
        service_fill(client)
        fill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        client.compact()
        compact_s = time.perf_counter() - t0
        lat = []
        torch.cuda.synchronize()
        _reset(ops.launches, tpe_ops.launches)
        t0 = time.perf_counter()
        for rnd in range(SERVICE["rounds"]):
            service_round(client, rnd, lat)
        rounds_s = time.perf_counter() - t0
        launches = {"score_cov": ops.launches["score_cov"],
                    "var_downdate": ops.launches["var_downdate"],
                    "tpe_scores": tpe_ops.launches["tpe_scores"]}
        httpd.shutdown()
        svc.close()
        n_ops = svc.bank.op_seq
        ms = [1e3 * x for _, x in lat]
        log(f"[service] {SERVICE['B']} studies "
            + " + ".join(f"{c} {nm}" for nm, c in SERVICE_FAMILIES)
            + f", Hartmann-6, mc_samples "
            f"{svc.bank.space.mc_samples(SERVICE['batch'])} a study; "
            f"{SERVICE['B'] * SERVICE['n_obs']} observes over HTTP in "
            f"{fill_s:.2f} s; {n_ops} journaled ops, journal append + fsync "
            f"median {1e3 * _pct(journal, 50):.3f} ms, p90 "
            f"{1e3 * _pct(journal, 90):.3f} ms, mean "
            f"{1e3 * sum(journal) / len(journal):.3f} ms")
        log(f"[service] one compaction over HTTP {1e3 * compact_s:.1f} ms; "
            f"{SERVICE['rounds']} rounds of ask({SERVICE['batch']}) -> tell "
            f"in {rounds_s:.2f} s; HTTP ask median {_pct(ms, 50):.1f} ms, "
            f"p90 {_pct(ms, 90):.1f} ms; the same asks in the bank median "
            f"{1e3 * _pct(bank_ask, 50):.1f} ms, p90 "
            f"{1e3 * _pct(bank_ask, 90):.1f} ms; launches {launches}")
        for nm, c in SERVICE_FAMILIES:      # lat is round by round
            fam = [m for (f, _), m in zip(lat, ms) if f == nm]
            log(f"[service] {nm}: HTTP ask median {_pct(fam, 50):.1f} ms, "
                f"p90 {_pct(fam, 90):.1f} ms, max {max(fam):.1f} ms; "
                "summed per round " + ", ".join(
                    f"{sum(fam[r * c:(r + 1) * c]):.0f}"
                    for r in range(SERVICE["rounds"])) + " ms")
        gp, tpe, cl = (c for _, c in SERVICE_FAMILIES)
        want = {"score_cov": SERVICE["rounds"] * (gp + cl),
                "var_downdate": SERVICE["rounds"] * gp
                * (SERVICE["batch"] - 1),
                "tpe_scores": SERVICE["rounds"] * tpe}
        if launches != want:
            raise AssertionError(f"service asks launched {launches}, "
                                 f"want {want}")
        t0 = time.perf_counter()
        back = TuningService(os.path.join(tmp, "svc"), device=dev)
        torch.cuda.synchronize()
        recovery_s = time.perf_counter() - t0
        log(f"[service] restart on the data dir: {recovery_s:.2f} s "
            f"({back.recovery})")
        twin = TuningService(os.path.join(tmp, "twin"),
                             config=service_config(), device=dev)
        service_fill(twin)
        twin.compact()
        for rnd in range(SERVICE["rounds"]):
            service_round(twin, rnd)
        bad = [name for name, _ in service_studies()
               if back.trials(name) != twin.trials(name)]
        if bad or back.bank.op_seq != twin.bank.op_seq:
            raise AssertionError(f"restarted service diverged from its "
                                 f"twin: studies {bad}")
        ends = [service_studies()[i][0] for i in (0, gp, gp + tpe)]
        for name in ends:
            a = back.ask(name, SERVICE["batch"], req_id="next")["trials"]
            b = twin.ask(name, SERVICE["batch"], req_id="next")["trials"]
            if a != b:
                raise AssertionError(f"{name}: next proposals differ "
                                     f"after recovery: {a} != {b}")
        log(f"[service] restarted == uninterrupted twin: {SERVICE['B']} "
            f"ledgers JSON-equal, op_seq {back.bank.op_seq}, next "
            f"ask({SERVICE['batch']}) bit-equal for {ends}")
        back.close()
        twin.close()
    return launches


def chaos_path(dev):
    """Phase 20d: the chaos grid (5 seeded SIGKILLs, the JAX package's
    default config and workload), server subprocesses and the in-process
    oracle on the card."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rep = chaos.run(tmp, kills=5, seed=0, device=str(dev))
        wall = time.perf_counter() - t0
    log(f"[chaos] {rep['kills_fired']}/{rep['kills_requested']} kills fired "
        f"({rep['fired']}) over {rep['steps']} steps in {wall:.2f} s; "
        "seconds to SERVING per server start (first, restarts, final): "
        + ", ".join(f"{x:.2f}" for x in rep["start_s"]))
    if rep["failures"] or rep["kills_fired"] < 4:
        raise AssertionError(f"chaos: {rep['failures']}, "
                             f"{rep['kills_fired']} kills fired")


# --------------------------------------------------------------------------- #
# phase 21: the single-study strategies, hallucination_ref and the examples
# --------------------------------------------------------------------------- #
SINGLE = dict(n_obs=FLEET["n_obs"], batch=FLEET["batch"], pending=3, asks=5)
# launches of (score_cov, var_downdate, tpe_scores) per ask of batch b, from
# the reference's dispatch: hallucination_ref scores every slot on the host
# loop; the fused factor core scores once and downdates b - 1 times
SINGLE_LAUNCHES = {
    "hallucination_ref chol": lambda b: (0, 0, 0),
    "hallucination_ref kinv_pallas": lambda b: (b, 0, 0),
    "fused chol": lambda b: (0, 0, 0),
    "fused kinv_pallas": lambda b: (1, b - 1, 0),
    "clustering": lambda b: (1, 0, 0),
    "clustering propose_host": lambda b: (0, 0, 0),
    "tpe": lambda b: (0, 0, 1),
    "tpe pending_penalty": lambda b: (0, 0, 1),
}


def single_study_inputs(seed=0):
    """Phase 3's Hartmann-6 stream for one study (its 200 observations),
    three more of its points in flight, and one draw of the default
    candidate budget."""
    from repro_torch.core import ParamSpace
    rng = np.random.default_rng(seed + 1000)
    rows = rng.uniform(size=(SINGLE["n_obs"] + SINGLE["pending"], 6))
    y = np.array([neg_hartmann6({f"x{i}": float(x) for i, x in enumerate(r)})
                  for r in rows[:SINGLE["n_obs"]]], np.float32)
    space = ParamSpace(hartmann_space())
    n_mc = space.mc_samples(SINGLE["batch"])
    cols = space.sample_columns(n_mc, np.random.default_rng(seed + 21))
    C = np.asarray(space.encode_columns(cols, n_mc), np.float32)
    X = rows.astype(np.float32)
    return X[:SINGLE["n_obs"]], y, C, X[SINGLE["n_obs"]:], space.domain_size


def _single_strategy(tag, dom, dev):
    from repro_torch.core.strategies import (ClusteringStrategy,
                                             FusedHallucinationStrategy,
                                             HallucinationStrategy)
    from repro_torch.core.tpe import TPEStrategy
    if tag.startswith("tpe"):
        return TPEStrategy(6, dom, device=dev,
                           pending_penalty="penalty" in tag)
    if tag.startswith("clustering"):
        return ClusteringStrategy(6, dom, device=dev)
    cls = (HallucinationStrategy if tag.startswith("hallucination_ref")
           else FusedHallucinationStrategy)
    return cls(6, dom, device=dev, scorer=tag.split()[-1])


def _single_judge(tag, cpu, X, y, C, P, dom, seed, got, want):
    """(near-tie, what the judge saw) for differing card and CPU picks of
    one single-study ask: phase 7's oracles on the CPU strategy's fitted
    GP (GP-BUCB, TPE) and phase 19's float64 replay ``cluster_replay``
    (clustering)."""
    from repro_torch.core.kmeans import kmeans_uniforms
    from repro_torch.core.strategies import n_top_candidates
    if tag.startswith("tpe"):
        oracle = top_b_oracle(tpe_score64(X, y, C, cpu.gamma,
                                          P if "penalty" in tag else None))
        ok, slot = picks_agree(got, want, oracle)
        return ok, f"from slot {slot}"
    st = cpu.gp.state
    z = (y - st.y_mean) / st.y_std
    hyp = (st.ls.cpu().numpy(), float(st.var), float(st.noise))
    if tag.startswith("clustering"):
        acq = bucb_acquisition(X, z, C, *hyp, [], dom, P)
        n = len(got)
        _, m = cluster_replay(acq, C, n, n_top_candidates(len(C), n, 0.2),
                              kmeans_uniforms([seed], n)[0])
        return cluster_near_tie(m), "margins " + ", ".join(
            f"{k} {v:.2e}" for k, v in m.items())
    ok, slot = picks_agree(got, want, lambda prev: bucb_acquisition(
        X, z, C, *hyp, prev, dom, P))
    return ok, f"from slot {slot}"


def single_study_path(dev):
    """Phase 21a: one study's asks on the card: ``HallucinationStrategy``
    and ``FusedHallucinationStrategy`` on the L-based path and the factor
    core, ``ClusteringStrategy.propose`` (and ``propose_host``),
    ``TPEStrategy.propose`` with the pending penalty off and on, each with
    0 and 3 trials in flight.  Each configuration: the CPU strategy asks
    once; the card strategy starts from a copy of the CPU strategy's GP
    (``convert``) and asks ``SINGLE["asks"]`` times, with each ask's
    launches held to ``SINGLE_LAUNCHES``; the card's picks are held against
    the CPU's (near-ties by ``_single_judge``) and the condition estimate
    card vs CPU.  Returns the launches summed over the phase."""
    from repro_torch import convert
    X, y, C, P_all, dom = single_study_inputs()
    n = SINGLE["batch"]
    log(f"[single] one study: {len(y)} Hartmann-6 observations, "
        f"{len(C)} candidates, batch {n}, 0 and {len(P_all)} in flight, "
        f"{SINGLE['asks']} card asks each")
    total = dict(score_cov=0, var_downdate=0, tpe_scores=0)
    bad = ties = 0
    for tag in SINGLE_LAUNCHES:
        for n_pend in (0, SINGLE["pending"]):
            P = P_all[:n_pend] if n_pend else None
            seed = 7
            cpu = _single_strategy(tag, dom, "cpu")
            card = _single_strategy(tag, dom, dev)
            if hasattr(cpu, "gp"):
                # both sides start from one fitted GP: the fused and
                # clustering asks observe nothing new and keep it; the
                # reference loop refits from its log-params
                cpu.gp.observe(X, y)
                card.gp = convert.gaussian_process_from_numpy(
                    convert.gaussian_process_to_numpy(cpu.gp), dev)
            host = tag.endswith("propose_host")
            call = "propose_host" if host else "propose"
            t0 = time.perf_counter()
            want = getattr(cpu, call)(X, y, C, n, seed=seed, pending=P)
            cpu_s = time.perf_counter() - t0
            times, got = [], None
            for _ in range(SINGLE["asks"]):
                _reset(ops.launches, tpe_ops.launches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                picks = getattr(card, call)(X, y, C, n, seed=seed, pending=P)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                seen = (ops.launches["score_cov"],
                        ops.launches["var_downdate"],
                        tpe_ops.launches["tpe_scores"])
                if seen != SINGLE_LAUNCHES[tag](n):
                    raise AssertionError(
                        f"{tag}: launches (score_cov, var_downdate, "
                        f"tpe_scores) {seen}, expected "
                        f"{SINGLE_LAUNCHES[tag](n)}")
                for k, v in zip(total, seen):
                    total[k] += v
                got = got or picks
            cond = ""
            if hasattr(card, "gp") and cpu.last_cond_proxy is not None:
                # staged by the fused and clustering asks (as in the JAX
                # package, the reference loop stages none)
                cc, cg = cpu.last_cond_proxy, card.last_cond_proxy
                cond = (f", last_cond_proxy card {cg:.6e} cpu {cc:.6e}")
                if abs(cg - cc) > 1e-3 * cc:
                    raise AssertionError(f"{tag}: condition estimates "
                                         f"{cg} vs {cc}")
            verdict = "equal"
            if got != want:
                ok, seen_by = _single_judge(tag, cpu, X, y, C, P, dom, seed,
                                            got, want)
                verdict = ("near-tie" if ok else "DISAGREE") + \
                    f" ({seen_by}): cuda {got} cpu {want}"
                ties += ok
                bad += not ok
            log(f"[single] {tag}, {n_pend} in flight: picks {verdict}; "
                f"median ask {float(np.median(times)):.2f} ms (host clock, "
                f"synchronized; all {', '.join(f'{t:.2f}' for t in times)})"
                f"; launches per ask {SINGLE_LAUNCHES[tag](n)}; CPU ask "
                f"{cpu_s:.2f} s{cond}")
    log(f"[single] configurations {2 * len(SINGLE_LAUNCHES)}, near-ties "
        f"{ties}, disagreements {bad}; launches {total}")
    if bad:
        raise AssertionError(f"{bad} single-study asks disagree")
    return total


def ref_tuner_path(dev):
    """Phase 21b: ``Tuner(optimizer="hallucination_ref")`` with the factor
    core on phase 6's mixed Branin, batch 5 x 15, on the card; the same
    run checkpointed at iteration 7 and resumed by a fresh Tuner must try
    the same configurations.  Returns the launches of both runs."""
    import tempfile
    conf = dict(optimizer="hallucination_ref", batch_size=5,
                num_iteration=15, seed=3, scheduler=SerialScheduler(),
                strategy_kwargs={"scorer": "kinv_pallas"}, device=dev)
    _reset(ops.launches)
    t0 = time.perf_counter()
    full = Tuner(branin_space(), modified_branin, conf).minimize()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(ops.launches)
    log(f"[ref-tuner] mixed Branin, hallucination_ref (kinv_pallas) batch "
        f"5 x 15: best {full.best_objective:.5f} at {full.best_params} "
        f"({wall:.2f} s, launches {got})")
    if pick_launches(got) != {"score_cov": 15 * 5, "var_downdate": 0}:
        raise AssertionError(f"hallucination_ref Tuner launched {got}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ref_tuner.json")
        Tuner(branin_space(), modified_branin,
              dict(conf, num_iteration=7, checkpoint_path=ckpt)).minimize()
        t0 = time.perf_counter()
        resumed = Tuner(branin_space(), modified_branin,
                        dict(conf, checkpoint_path=ckpt)).minimize()
        torch.cuda.synchronize()
        rwall = time.perf_counter() - t0
    same = resumed.params_tried == full.params_tried
    log(f"[ref-tuner] checkpointed at iteration 7, resumed by a fresh "
        f"Tuner: {len(resumed.params_tried)} configurations tried, "
        f"{'identical to' if same else 'DIFFERENT from'} the uninterrupted "
        f"run ({rwall:.2f} s for the last 8 iterations)")
    if not same:
        raise AssertionError("the resumed hallucination_ref Tuner differs")
    return {"score_cov": ops.launches["score_cov"], "var_downdate": 0}


EXAMPLE_RUNS = (("quickstart", []), ("distributed_tuning", []),
                ("serve_batched", []),
                ("tune_training", ["--full-width", "--iterations", "2",
                                   "--batch", "2", "--trial-steps", "5"]))


def examples_path(dev):
    """Phase 21c: the four examples, each through its ``main`` on the card
    (``tune_training`` at smollm-135m's full width, 2 iterations of 2
    trials, 5 steps a trial).  Returns the GP and TPE kernels' launches
    over the four."""
    import importlib
    _reset(ops.launches, tpe_ops.launches)
    for name, argv in EXAMPLE_RUNS:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        t0 = time.perf_counter()
        out = mod.main(argv + ["--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "distributed_tuning":
            res = out["sync"]
            summary = (f"sync best {res.best_objective:.4f} "
                       f"({len(res.objective_values)} observed, "
                       f"{res.n_failed} lost), async best "
                       f"{out['async'].best_objective:.4f} "
                       f"({len(out['async'].objective_values)} evals)")
            ok = res.best_objective > 0.9
        elif name == "serve_batched":
            summary = (f"generated {out['generated_shape']}, decode "
                       f"{out['decode_tok_s']} tokens/s")
            ok = out["generated_shape"][1] == 12 and out["logits_finite"]
        else:
            summary = (f"best {out.best_objective:.5f} over "
                       f"{len(out.objective_values)} trials")
            ok = math.isfinite(out.best_objective) and (
                name != "quickstart" or out.best_objective > 0.85)
        log(f"[examples] {name}: {summary}; {wall:.2f} s")
        if not ok:
            raise AssertionError(f"example {name}: {summary}")
    got = {**ops.launches, **tpe_ops.launches}
    log(f"[examples] launches over the four: {got}")
    if got["score_cov"] < 1:
        raise AssertionError(f"the examples' tuners skipped score_cov: {got}")
    return got


# --------------------------------------------------------------------------- #
# phase 22: the steady-state contract under the sanitizers
# --------------------------------------------------------------------------- #
SANITIZE_FAMILIES = (
    ("gp", {}),
    ("tpe", dict(optimizer="tpe", strategy_kwargs={"pending_penalty": True})),
    ("cluster", dict(optimizer="clustering")))
# the audited asks of each family: FLEET["rounds"] ask -> tell rounds, then
# one ask left in flight and one that takes it in (``bank_absorb``)
SANITIZE_ASKS = FLEET["rounds"] + 2
SANITIZE_LAUNCHES = {   # (score_cov, var_downdate, tpe_scores) per family
    "gp": (SANITIZE_ASKS, SANITIZE_ASKS * (FLEET["batch"] - 1), 0),
    "tpe": (0, 0, SANITIZE_ASKS),
    "cluster": (SANITIZE_ASKS, 0, 0)}


def sanitizer_smoke_path(dev):
    """Phase 22a: ``repro_torch.analysis.smoke.run`` on the card at the
    reference's size (4 studies, 32 candidates, 3 warm and 6 audited rounds
    of ask_all(1)).  Returns its launches."""
    from repro_torch.analysis import smoke
    _reset(ops.launches, tpe_ops.launches)
    t0 = time.perf_counter()
    smoke.run(device=dev, verbose=False)
    torch.cuda.synchronize()
    got = dict(ops.launches)
    log(f"[sanitize] smoke.run on the card: 6 audited ask_all(1) rounds x 4 "
        f"studies under no_transfer() + no_retrace() passed in "
        f"{time.perf_counter() - t0:.2f} s; launches of its 9 rounds {got}")
    if got["score_cov"] < 6:
        raise AssertionError(f"the smoke's asks skipped score_cov: {got}")
    return got


def _audited_fleet(dev, fam, kw):
    """Phase 22b for one family: phase 3's fleet warmed through every
    signature its audited asks meet (an ask -> tell round, then an ask with
    a batch in flight), then ``SANITIZE_ASKS`` asks under
    ``no_transfer()`` and ``no_retrace()``: 0 hidden syncs (the guard's
    error mode raises on the first), 0 new signatures and 0 builds.
    Returns the bank (a batch in flight) and the audited launches."""
    from repro_torch.analysis.sanitizers import no_retrace, no_transfer
    n = FLEET["batch"]
    bank = seeded_fleet(dev, seed=5, **kw)
    _tell_all(bank, bank.ask_all(n))
    bank.ask_all(n)
    _tell_all(bank, bank.ask_all(n))
    for b, v in enumerate(bank.studies):
        for t in v.pending_trials():
            bank.tell(b, t.id, neg_hartmann6(t.params))
    _reset(ops.launches, tpe_ops.launches)
    t0 = time.perf_counter()
    with no_transfer(device=dev), no_retrace() as rep:
        for _ in range(FLEET["rounds"]):
            trials = bank.ask_all(n)
            check_picks(trials, n)
            _tell_all(bank, trials)
        bank.ask_all(n)                        # left in flight
        trials = bank.ask_all(n)               # takes them in
        check_picks(trials, n)
    wall = time.perf_counter() - t0
    got = (ops.launches["score_cov"], ops.launches["var_downdate"],
           tpe_ops.launches["tpe_scores"])
    log(f"[sanitize] {fam} fleet: {SANITIZE_ASKS} audited ask_all({n}) "
        f"(the last with {n} trials per study in flight) in {wall:.2f} s: "
        f"0 hidden syncs, new signatures {sum(rep.deltas.values())} over "
        f"{len(rep.jits)} audited entries (builds included); launches "
        f"(score_cov, var_downdate, tpe_scores) {got}")
    if got != SANITIZE_LAUNCHES[fam]:
        raise AssertionError(f"{fam}: audited launches {got}, expected "
                             f"{SANITIZE_LAUNCHES[fam]}")
    _tell_all(bank, trials)
    return bank, dict(zip(("score_cov", "var_downdate", "tpe_scores"), got))


def _in_flight_walls(bank, reps=3):
    """Ask walls (ms, host clock around synchronized work) with one batch
    per study in flight; each ask's own trials are told failed."""
    n = FLEET["batch"]
    walls = []
    for _ in range(reps):
        trials, ms = _timed_ask(bank, n)
        walls.append(ms)
        for b, ts in enumerate(trials):
            for t in ts:
                bank.tell_failed(b, t.id)
    return walls


def _negative_controls(bank, dev):
    """Phase 22c: an injected ``.item()`` on a bank tensor inside
    ``no_transfer()`` and a forced new bucket (an ask of another batch
    size) inside ``no_retrace()`` must both raise."""
    from repro_torch.analysis.sanitizers import (RetraceError, no_retrace,
                                                 no_transfer)
    try:
        with no_transfer(device=dev):
            bank._gp_cache["L"].sum().item()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        log(f"[sanitize] negative control: .item() on the bank's L inside "
            f"no_transfer() raised: {str(e).splitlines()[0]}")
    else:
        raise AssertionError("an injected .item() passed no_transfer()")
    try:
        with no_retrace():
            bank.ask_all(FLEET["batch"] + 1)
    except RetraceError as e:
        if "bank_pick=1/0" not in str(e):
            raise
        log(f"[sanitize] negative control: ask_all({FLEET['batch'] + 1}) "
            f"inside no_retrace() raised: {e}")
    else:
        raise AssertionError("a new bucket passed no_retrace()")


def sanitizer_fleet_path(dev):
    """Phase 22b and 22c: each family of ``SANITIZE_FAMILIES`` audited, its
    ask walls with a batch in flight, then the negative controls on the GP
    fleet.  Returns the audited launches summed."""
    total = dict(score_cov=0, var_downdate=0, tpe_scores=0)
    for fam, kw in SANITIZE_FAMILIES:
        bank, got = _audited_fleet(dev, fam, kw)
        for k in total:
            total[k] += got[k]
        walls = _in_flight_walls(bank)
        log(f"[sanitize] {fam} fleet: ask_all({FLEET['batch']}) with "
            f"{FLEET['batch']} trials per study in flight "
            + ", ".join(f"{w:.2f}" for w in walls)
            + " ms (host clock, synchronized)")
        if fam == "gp":
            _negative_controls(bank, dev)
        del bank
    log(f"[sanitize] audited launches over the three fleets {total}")
    return total


def _profiled(fn):
    """``fn()`` under torch.profiler; returns (its result, the wall ms, the
    profiler)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return out, wall, prof


# substrings of the port's own kernels' names (CUDA C++ entry functions)
PORT_KERNELS = ("score_cov", "var_downdate", "tpe_kde", "flash_", "mlstm",
                "ssm_")


def _device_rows(ka):
    """The device rows (kernels, copies, memsets) of a profiler's
    ``key_averages()``.  Only these are summed: an operator's row repeats
    the device time of the kernels it launched."""
    from torch.autograd import DeviceType
    return [e for e in ka if e.device_type == DeviceType.CUDA]


def _device_ms(e) -> float:
    return e.self_device_time_total / 1e3


def _report_profile(prof, wall, tag):
    """Device busy share of ``wall`` and the device rows and host ops that
    take the most time, the port's own kernels listed apart."""
    ka = prof.key_averages()
    rows = _device_rows(ka)
    ms = _device_ms
    busy = sum(ms(e) for e in rows)
    mine = [e for e in rows if any(k in e.key for k in PORT_KERNELS)]
    log(f"[profile] {tag}: wall {wall:.1f} ms under the profiler, "
        f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}% of wall) over "
        f"{sum(e.count for e in rows)} device rows; the port's kernels "
        f"{sum(ms(e) for e in mine):.2f} ms")
    for e in sorted(rows, key=ms, reverse=True)[:8]:
        log(f"[profile]   device {e.key[:56]:56s} {ms(e):9.3f} ms x{e.count}")
    for e in sorted(mine, key=ms, reverse=True)[:6]:
        log(f"[profile]   kernel {e.key[:56]:56s} {ms(e):9.3f} ms x{e.count}")
    for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:6]:
        log(f"[profile]   host   {e.key[:56]:56s} "
            f"{e.self_cpu_time_total / 1e3:9.3f} ms x{e.count}")


def _profile_ask(bank, tag, n):
    """One ``ask_all(n)`` under torch.profiler."""
    trials, wall, prof = _profiled(lambda: bank.ask_all(n))
    _report_profile(prof, wall, tag)
    return trials


def profile_serve(dev):
    """``--profile``: where a serving step's time goes.  smollm-135m, bf16,
    B 8, a 1024-token prompt (phase 8's first shape): after one untimed
    prefill, one prefill and then three decode steps under the profiler."""
    arch, B, P, _ = SERVE[0]
    cfg, rt = get_config(arch), Runtime()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, rt)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, P), dtype=np.int32), device=dev)
    prefill = make_prefill_step(cfg, rt, cache_size=P + 4)
    decode = make_decode_step(cfg, rt)
    prefill(params, {"tokens": tokens})
    (tok, cache, _), wall, prof = _profiled(
        lambda: prefill(params, {"tokens": tokens}))
    _report_profile(prof, wall, f"{arch} prefill B={B} prompt={P}")

    def steps():
        t, c = tok, cache
        for i in range(3):
            t, c, _ = decode(params, t[:, None], c, P + i)

    _, wall, prof = _profiled(steps)
    _report_profile(prof, wall, f"{arch} 3 decode steps B={B}")


def profile_path(bank, tpe_bank):
    """``--profile``: where a fleet ask's time goes.  GP: one ask whose
    observation stage is cached (the parity ask's trials and those left in
    flight told failed), then one after real tells (refit, factors and
    pick).  TPE: one ask of the pending-penalty fleet with a batch in
    flight.  Prints the device busy share of each ask's wall time and the
    kernels and host ops that take the most time, plus the host candidate
    draw timed alone."""
    n = FLEET["batch"]
    n_mc = bank.mc_samples or bank.space.mc_samples(n)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    cols = bank.space.sample_columns(FLEET["B"] * n_mc, rng)
    bank.space.encode_columns(cols, FLEET["B"] * n_mc)
    log(f"[profile] host candidate draw + encode of {FLEET['B'] * n_mc} "
        f"rows alone: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    for b, v in enumerate(bank.studies):
        for t in v.pending_trials():
            bank.tell_failed(b, t.id)
    for tag in ("GP, cached observation stage",
                "GP, after tells: refit, factors"):
        _tell_all(bank, _profile_ask(bank, tag, n))
    for b, v in enumerate(tpe_bank.studies):
        for t in v.pending_trials()[:-n]:
            tpe_bank.tell(b, t.id, neg_hartmann6(t.params))
    _profile_ask(tpe_bank, f"TPE, {n} trials per study in flight", n)


# --------------------------------------------------------------------------- #
# phase 23: the launch layer (meshes, DTensor layouts, plan cost, dry run)
# --------------------------------------------------------------------------- #
MESH_TRAIN = dict(arch="smollm-135m", batch=8, seq=1024, steps=4)
MESH_SERVE = dict(prompt=1024, gen=16)
# a greedy pick of the DTensor path may differ from the plain path's only
# where the plain path's two logits lie within this of each other (bf16
# activations; at one rank both paths run the same local ops)
MESH_TIE = 5e-2
DRYRUN_CELLS = (
    ["--all", "--mesh", "both"],
    ["--arch", "smollm-135m", "--shape", "train_4k", "--mesh", "single",
     "--trace"],
    ["--arch", "smollm-135m", "--shape", "train_4k", "--mesh", "multi",
     "--trace"])


def _dryrun_procs(cells=DRYRUN_CELLS, tag="baseline"):
    """Dry runs of ``cells``, started at once as CPU subprocesses (no card);
    phase 23f's by default: the analytic pass over every cell and both
    meshes, and smollm-135m train_4k traced on a fake 256- and 512-rank
    process group."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = ROOT / "build" / "dryrun"
    return [(argv, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out",
         str(out), "--tag", tag], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for argv in cells]


def _dryrun_wait(procs, t0, phase=23):
    for argv, p in procs:
        out, _ = p.communicate(timeout=600)
        lines = out.strip().splitlines()
        for line in lines:
            if line.startswith(("OK ", "FAIL")) and (
                    "--trace" in argv or line.startswith("FAIL")):
                log(f"[mesh-dryrun] {line}")
        log(f"[mesh-dryrun] {' '.join(argv)}: exit {p.returncode}, "
            f"{lines[-1] if lines else 'no output'} "
            f"({time.perf_counter() - t0:.1f} s since phase {phase} began)")
        if p.returncode != 0 or not lines or " cells OK" not in lines[-1]:
            raise AssertionError(f"dry run {argv} failed:\n" + "\n".join(
                lines[-30:]))


def _mesh_batches(cfg, n, B, S, dev, seed=23):
    rng = np.random.default_rng(seed)
    return [{k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32), device=dev)
             for k in ("tokens", "labels")} for _ in range(n)]


@contextlib.contextmanager
def _one_rank_mesh(dev):
    """A one-rank process group (NCCL on the card, gloo on the CPU; a
    ``FileStore`` under ``build/``) and its (data=1, model=1)
    ``DeviceMesh``, destroyed on exit."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    store_path = ROOT / "build" / "mesh_store"
    store_path.parent.mkdir(parents=True, exist_ok=True)
    store_path.unlink(missing_ok=True)
    on_card = dev.type == "cuda"
    dist.init_process_group(
        "nccl" if on_card else "gloo",
        store=dist.FileStore(str(store_path), 1), rank=0, world_size=1,
        device_id=(torch.device("cuda", torch.cuda.current_device())
                   if on_card else None))
    try:
        yield mesh_lib.device_mesh(mesh_lib.make_test_mesh((1, 1)), dev.type)
    finally:
        dist.destroy_process_group()


def _own_peak(peaks, key, inputs, run):
    """``run()`` timed on the host clock (synchronized), with its own peak:
    its inputs' bytes plus the most allocated above what was live when it
    began (the twin's state, earlier phases' leftovers), read from a peak
    reset just before it; ``peaks[key]`` keeps the largest (held, over)."""
    from repro_torch.launch.sharding import local_bytes
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - s0
    held = local_bytes(inputs)
    over = torch.cuda.max_memory_allocated() - base
    if held + over > sum(peaks[key]):
        peaks[key] = (held, over)
    return out, wall


def _greedy_vs_plain(pre, pre0, dec, dec0, params, params0, placed, prompt,
                     S, gen):
    """A prefill and ``gen`` greedy tokens on the mesh beside the plain
    path: a differing token is allowed only where the plain path's two
    logits lie within ``MESH_TIE`` (the streams stop there).  Returns the
    token rows equal, the near-ties, the mesh's cache and the flash
    launches of its prefill."""
    _reset(flash_ops.launches)
    tok, cache, _ = pre(params, placed)
    n_pre = dict(flash_ops.launches)
    tok0, cache0, lg0 = pre0(params0, prompt)
    same, ties = 0, 0
    for i in range(gen + 1):
        a, b = tok.full_tensor(), tok0
        diff = (a != b).nonzero().flatten().tolist()
        for r in diff:
            gap = abs(float(lg0[r, a[r]]) - float(lg0[r, b[r]]))
            if gap > MESH_TIE:
                raise AssertionError(
                    f"token {i} row {r}: DTensor {int(a[r])} vs plain "
                    f"{int(b[r])}, logit gap {gap:.4g}")
            ties += 1
        if diff:
            break  # the streams diverge on a near-tie
        same += 1
        if i == gen:
            break
        tok, cache, _ = dec(params, tok[:, None], cache, S + i)
        tok0, cache0, lg0 = dec0(params0, tok0[:, None], cache0, S + i)
    return same, ties, cache, n_pre


def mesh_path(dev):
    """Phase 23: smollm-135m at full width and depth on a one-rank NCCL
    ``DeviceMesh`` (data=1, model=1) with DTensor state, beside the plain
    path from the same state.  (a) ``MESH_TRAIN`` AdamW steps in bf16
    (remat none) with the state placed by ``param_specs``: losses and grad
    norms within phase 11's tolerances of the plain step's, 30 flash forward
    and 30 backward launches per DTensor step (counters set to 0 just before
    each DTensor step and read just after); (b) a 1024-token prefill and 16
    greedy tokens with a DTensor cache placed by ``cache_specs``: tokens
    equal to the plain path's but on near-ties; (c) the step's wall and
    its own peak memory (its state and batch plus what it allocates above
    what was live when it began) beside ``estimate_plan(..., n_devices=1)``,
    ``fits`` held against that peak and the card's memory; (d) ``compressed_psum`` over the
    data group on NCCL against the local quantise-dequantise; (e) a save
    from the DTensor state restored onto its placements, bitwise; (f) the
    dry runs of ``DRYRUN_CELLS`` in CPU subprocesses, started first.
    Returns the flash launches of the DTensor steps and the prefill."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import cost, roofline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.optim.compression import compressed_psum
    from repro_torch.train.checkpoint import Checkpointer

    t0 = time.perf_counter()
    procs = _dryrun_procs()
    with _one_rank_mesh(dev) as dm:
        T = MESH_TRAIN
        cfg = get_config(T["arch"])
        rt = Runtime(sc=mesh_lib.make_shard_ctx(dm), remat_policy="none")
        rt0 = Runtime(remat_policy="none")
        hyper = TrainHyper()
        state0 = init_train_state(torch.Generator(device=dev).manual_seed(0),
                                  cfg, rt0)
        specs = sharding.train_state_specs(state0["params"], cfg, rt.sc)
        state = sharding.distribute_tree(_copy_to(state0, dev), specs, dm)
        step = make_train_step(cfg, rt, hyper)
        step0 = make_train_step(cfg, rt0, hyper)
        per = sum(s.mixer == "attn" for s in layer_specs(cfg))
        counts = {"flash_attention": 0, "flash_attention_bwd": 0}
        walls, walls0, worst = [], [], (0.0, 0.0)
        peaks = {"dtensor": (0, 0), "plain": (0, 0)}
        for i, batch in enumerate(_mesh_batches(cfg, T["steps"], T["batch"],
                                                T["seq"], dev)):
            placed = sharding.distribute_tree(
                batch, sharding.batch_specs(batch, rt.sc, T["batch"]), dm)
            _reset(flash_ops.launches)
            (state, m), w = _own_peak(peaks, "dtensor", (state, placed),
                                      lambda: step(state, placed))
            walls.append(w)
            n = dict(flash_ops.launches)
            for k in counts:
                counts[k] += n[k]
            (state0, m0), w = _own_peak(peaks, "plain", (state0, batch),
                                        lambda: step0(state0, batch))
            walls0.append(w)
            loss, gn = (float(m["loss"].full_tensor()),
                        float(m["grad_norm"].full_tensor()))
            loss0, gn0 = float(m0["loss"]), float(m0["grad_norm"])
            worst = (max(worst[0], _rel(loss, loss0)),
                     max(worst[1], _rel(gn, gn0)))
            log(f"[mesh-train] {T['arch']} bf16 B={T['batch']} S={T['seq']} "
                f"mesh (data=1, model=1) {dist.get_backend()} step {i}: loss "
                f"{loss:.6f} vs "
                f"plain {loss0:.6f}, grad norm {gn:.6f} vs {gn0:.6f}; "
                f"DTensor step {walls[-1] * 1e3:.1f} ms, plain step "
                f"{walls0[-1] * 1e3:.1f} ms (host clock, synchronized); "
                f"flash launches {n}")
            if n != {"flash_attention": per, "flash_attention_bwd": per}:
                raise AssertionError(f"step {i}: flash launches {n}, "
                                     f"expected {per} each way")
            if not (math.isfinite(loss) and math.isfinite(gn)):
                raise AssertionError("non-finite loss or grad norm")
        peak = sum(peaks["dtensor"])
        log(f"[mesh-train] largest relative difference DTensor vs plain: "
            f"loss {worst[0]:.3g} (tolerance {TRAIN_LOSS_RTOL}), grad norm "
            f"{worst[1]:.3g} (tolerance {TRAIN_GNORM_RTOL})")
        if worst[0] > TRAIN_LOSS_RTOL or worst[1] > TRAIN_GNORM_RTOL:
            raise AssertionError(f"DTensor step off the plain step: {worst}")

        # (b) prefill + greedy decode on the mesh
        S = MESH_SERVE["prompt"]
        prompt = {"tokens": _mesh_batches(cfg, 1, T["batch"], S, dev,
                                          seed=24)[0]["tokens"]}
        cache_size = S + MESH_SERVE["gen"]
        pre = make_prefill_step(cfg, rt, cache_size=cache_size)
        pre0 = make_prefill_step(cfg, rt0, cache_size=cache_size)
        dec, dec0 = make_decode_step(cfg, rt), make_decode_step(cfg, rt0)
        pt = sharding.distribute_tree(
            prompt, sharding.batch_specs(prompt, rt.sc, T["batch"]), dm)
        same, ties, cache, n_pre = _greedy_vs_plain(
            pre, pre0, dec, dec0, state["params"], state0["params"], pt,
            prompt, S, MESH_SERVE["gen"])
        placements = {str(cache[0]["k"].placements)}
        log(f"[mesh-serve] {T['arch']} bf16 B={T['batch']} prompt {S}, "
            f"{MESH_SERVE['gen']} greedy tokens on the mesh, cache "
            f"placements {placements}: {same} of {MESH_SERVE['gen'] + 1} "
            f"token rows equal to the plain path's, {ties} near-ties; flash "
            f"launches in the prefill {n_pre}")
        if n_pre["flash_attention"] != per:
            raise AssertionError(f"prefill flash launches {n_pre}")
        counts["flash_attention"] += n_pre["flash_attention"]

        # (c) estimate vs measured
        shape = ShapeConfig("phase23", T["seq"], T["batch"], "train")
        plan = {"tp": 1, "remat": "none", "micro": 1}
        est = cost.estimate_plan(cfg, shape, plan, n_devices=1)
        steady = walls[1:] or walls
        wall = sum(steady) / len(steady)
        wall0 = sum(walls0[1:] or walls0) / len(walls0[1:] or walls0)
        total = torch.cuda.get_device_properties(0).total_memory
        # the estimate's resident terms at one device: bf16 parameters
        # (2 B) and fp32 optimizer state (12 B) a parameter; the rest is
        # its stored activations
        est_state = 14.0 * cfg.param_count()["total"]
        est_act = est["hbm_gb"] * 1e9 - est_state
        (held, over), (held0, over0) = peaks["dtensor"], peaks["plain"]
        log(f"[mesh-cost] estimate_plan(n_devices=1, {plan}) on "
            f"{roofline.H100.name}: step {est['t_step_s'] * 1e3:.2f} ms "
            f"(compute {est['t_compute_s'] * 1e3:.2f}, memory "
            f"{est['t_memory_s'] * 1e3:.2f}), {est['hbm_gb']:.3f} GB "
            f"(state {est_state / 1e9:.3f}, activations "
            f"{est_act / 1e9:.3f}), fits {est['fits']}; measured DTensor "
            f"step {wall * 1e3:.1f} ms (ratio measured/estimate "
            f"{wall / est['t_step_s']:.2f}), plain step {wall0 * 1e3:.1f} ms "
            f"(DTensor/plain {wall / wall0:.3f}); the DTensor step's own "
            f"peak {peak / 1e9:.3f} GB = its state and batch "
            f"{held / 1e9:.3f} + {over / 1e9:.3f} allocated above them "
            f"(ratios measured/estimate: peak "
            f"{peak / 1e9 / est['hbm_gb']:.2f}, state "
            f"{held / est_state:.2f}, above-state/activations "
            f"{over / est_act:.2f}); the plain step's own peak "
            f"{(held0 + over0) / 1e9:.3f} GB = {held0 / 1e9:.3f} + "
            f"{over0 / 1e9:.3f}; card memory {total / 1e9:.1f} GB")
        fits_measured = peak <= roofline.H100.hbm_bytes and peak <= total
        if est["fits"] != fits_measured:
            raise AssertionError(f"fits {est['fits']} but the peak "
                                 f"{peak} says {fits_measured}")

        # (d) int8 all-reduce over the data group
        x = torch.randn(1 << 20, generator=torch.Generator(
            device=dev).manual_seed(5), device=dev)
        got = compressed_psum(x, dm.get_group("data"))
        scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
        want = torch.clamp(torch.round(x / scale), -127, 127) * scale
        err = float((got - want).abs().max())
        log(f"[mesh-psum] compressed_psum of {x.numel()} floats over the "
            f"data group ({dist.get_backend()}, 1 rank): max |got - local dequantised| "
            f"{err:.3g}, one quantum {float(scale):.3g}")
        if not err <= float(scale):
            raise AssertionError("compressed_psum off by more than a quantum")

        # (e) save from the DTensor state, restore onto its placements
        with tempfile.TemporaryDirectory() as d:
            ck = Checkpointer(d, cfg, async_save=False)
            ck.save(T["steps"], state)
            got, meta = ck.restore(None, state,
                                   placements=sharding.to_shardings(specs,
                                                                    dm))
        bad = [p for (p, a), (_, b) in zip(tree_items(got), tree_items(state))
               if torch.is_tensor(a) and not (
                   a.placements == b.placements
                   and torch.equal(a.full_tensor(), b.full_tensor()))]
        log(f"[mesh-ckpt] saved the DTensor state at step {meta['step']} and "
            f"restored it onto its placements: {len(bad)} leaves differ")
        if bad or got["opt"]["step"] != state["opt"]["step"]:
            raise AssertionError(f"restore differs at {bad[:4]}")
    _dryrun_wait(procs, t0)
    log(f"[mesh] phase 23 took {time.perf_counter() - t0:.1f} s")
    return counts


# --------------------------------------------------------------------------- #
# phase 24: the MoE, Mamba, xLSTM and whisper paths on the mesh
# --------------------------------------------------------------------------- #
# full width, depth cut; each beside its plain twin from the same seed on
# phase 23's one-rank mesh (two twins' states, 10 bytes a parameter, fit
# the card: olmoe's cut is the largest, ~1.05 B parameters)
MESH_FAMILIES = (
    dict(arch="olmoe-1b-7b", rt=dict(moe_expert_parallel=True), batch=4,
         seq=1024, serve_batch=4, prompt=512),
    dict(arch="jamba-v0.1-52b", rt={}, batch=1, seq=2048, serve_batch=2,
         prompt=1024),
    dict(arch="xlstm-1.3b", rt={}, batch=2, seq=1024, serve_batch=2,
         prompt=256),
    dict(arch="whisper-large-v3", rt={}, batch=4, seq=448, serve_batch=8,
         prompt=64),
)
MESH_FAMILY_STEPS, MESH_FAMILY_GEN = 3, 16
# one traced cell per family on the fake 256-rank group, in CPU subprocesses
FAMILY_DRYRUN_CELLS = tuple(
    ["--arch", a, "--shape", sh, "--mesh", "single", "--trace", *flags]
    for a, sh, flags in (("olmoe-1b-7b", "train_4k", ["--ep"]),
                         ("jamba-v0.1-52b", "decode_32k", []),
                         ("xlstm-1.3b", "decode_32k", []),
                         ("whisper-large-v3", "decode_32k", [])))
AUX_METRICS = ("moe_lb_loss", "moe_router_z", "moe_drop_frac")


def family_cut(arch):
    """``arch`` at full width, its depth cut: olmoe to 2 layers (attention
    + MoE), jamba to (Mamba, dense) + (attention, dense) (its MoE layer
    alone is ~2.8 B parameters), xLSTM to one mLSTM and one sLSTM layer,
    whisper to 4 encoder + 4 decoder layers."""
    import dataclasses
    from repro_torch.configs.base import LayerSpec
    if arch == WHISPER:
        return whisper_cut(4)
    period = {"olmoe-1b-7b": (LayerSpec("attn", "moe"),) * 2,
              "jamba-v0.1-52b": (LayerSpec("mamba", "dense"),
                                 LayerSpec("attn", "dense")),
              "xlstm-1.3b": (LayerSpec("mlstm", "none"),
                             LayerSpec("slstm", "none"))}[arch]
    return dataclasses.replace(get_config(arch), n_layers=len(period),
                               period=period)


def family_launches(cfg):
    """Each kernel's launches in one training step (remat none): one
    forward and one backward a layer of its mixer."""
    fl = flash_per_prefill(cfg)
    n = {"flash_attention": fl, "flash_attention_bwd": fl,
         "ssm_scan": _mixers(cfg, "mamba"),
         "ssm_scan_bwd": _mixers(cfg, "mamba"),
         "mlstm_chunk": _mixers(cfg, "mlstm"),
         "mlstm_chunk_bwd": _mixers(cfg, "mlstm")}
    return {k: v for k, v in n.items() if v}


def _family_batches(cfg, B, S, dev, n, seed):
    out = _mesh_batches(cfg, n, B, S, dev, seed=seed)
    if cfg.encoder_layers:
        for i, b in enumerate(out):
            b["frames"] = torch.as_tensor(train.frames_at(seed, i, B, cfg),
                                          device=dev)
    return out


def _family_on_mesh(F, dm, dev, counts):
    """One family of phase 24: (a) DTensor AdamW steps beside the plain
    twin, (b) prefill + greedy decode with a DTensor cache, (c) walls and
    own peaks.  Adds the DTensor steps' launches to ``counts``."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    cfg = family_cut(F["arch"])
    rt = Runtime(sc=mesh_lib.make_shard_ctx(dm), remat_policy="none",
                 **F["rt"])
    rt0 = Runtime(remat_policy="none", **F["rt"])
    ep = rt.moe_expert_parallel
    hyper = TrainHyper()
    state0 = init_train_state(torch.Generator(device=dev).manual_seed(0),
                              cfg, rt0)
    specs = sharding.train_state_specs(state0["params"], cfg, rt.sc, ep)
    state = sharding.distribute_tree(_copy_to(state0, dev), specs, dm)
    n_param = sum(t.numel() for _, t in tree_items(state0["params"]))
    step = make_train_step(cfg, rt, hyper)
    step0 = make_train_step(cfg, rt0, hyper)
    want = family_launches(cfg)
    tag = f"{F['arch']} cut ({cfg.n_layers}+{cfg.encoder_layers} layers)"
    keys = ("loss",) + (AUX_METRICS if any(
        s.ffn == "moe" for s in layer_specs(cfg)) else ())
    worst = {k: 0.0 for k in keys + ("grad_norm",)}
    walls, walls0 = [], []
    peaks = {"dtensor": (0, 0), "plain": (0, 0)}
    kernel_counters = (flash_ops.launches, ssm_ops.launches,
                       mlstm_ops.launches)
    B, S = F["batch"], F["seq"]
    for i, batch in enumerate(_family_batches(cfg, B, S, dev,
                                              MESH_FAMILY_STEPS, seed=24)):
        placed = sharding.distribute_tree(
            batch, sharding.batch_specs(batch, rt.sc, B), dm)
        _reset(*kernel_counters)
        (state, m), w = _own_peak(peaks, "dtensor", (state, placed),
                                  lambda: step(state, placed))
        walls.append(w)
        n = {k: v for c in kernel_counters for k, v in c.items() if v}
        for k, v in n.items():
            counts[k] = counts.get(k, 0) + v
        (state0, m0), w = _own_peak(peaks, "plain", (state0, batch),
                                    lambda: step0(state0, batch))
        walls0.append(w)
        got = {k: float(m[k].full_tensor()) for k in worst}
        ref_ = {k: float(m0[k]) for k in worst}
        for k in worst:
            worst[k] = max(worst[k], _rel(got[k], ref_[k]))
        log(f"[mesh-family] {tag} bf16 B={B} S={S} mesh (data=1, model=1) "
            f"{dist.get_backend()} step {i}: "
            + ", ".join(f"{k} {got[k]:.6f} vs plain {ref_[k]:.6f}"
                        for k in worst)
            + f"; DTensor step {walls[-1] * 1e3:.1f} ms, plain step "
            f"{walls0[-1] * 1e3:.1f} ms (host clock, synchronized); "
            f"launches {n}")
        if n != want:
            raise AssertionError(f"{tag} step {i}: launches {n}, expected "
                                 f"{want}")
        if not all(math.isfinite(v) for v in got.values()):
            raise AssertionError(f"{tag}: non-finite metrics {got}")
    tol = {k: TRAIN_LOSS_RTOL for k in keys}
    tol["grad_norm"] = TRAIN_GNORM_RTOL
    log(f"[mesh-family] {tag}: largest relative difference DTensor vs "
        "plain: " + ", ".join(f"{k} {worst[k]:.3g} (tolerance {tol[k]})"
                              for k in worst))
    bad = [k for k in worst if worst[k] > tol[k]]
    if bad:
        raise AssertionError(f"{tag}: DTensor step off the plain step in "
                             f"{bad}: {worst}")
    steady = walls[1:] or walls
    steady0 = walls0[1:] or walls0
    (held, over), (held0, over0) = peaks["dtensor"], peaks["plain"]
    log(f"[mesh-family] {tag}: {n_param} parameters; DTensor step "
        f"{sum(steady) / len(steady) * 1e3:.1f} ms after a first of "
        f"{walls[0] * 1e3:.1f}, plain step "
        f"{sum(steady0) / len(steady0) * 1e3:.1f} ms (DTensor/plain "
        f"{sum(steady) / sum(steady0):.3f}); own peak DTensor "
        f"{(held + over) / 1e9:.3f} GB = {held / 1e9:.3f} state and batch "
        f"+ {over / 1e9:.3f} above, plain {(held0 + over0) / 1e9:.3f} GB = "
        f"{held0 / 1e9:.3f} + {over0 / 1e9:.3f}")

    # (b) prefill + greedy decode with a DTensor cache
    Bs, P, gen = F["serve_batch"], F["prompt"], MESH_FAMILY_GEN
    prompt = {k: v for k, v in _family_batches(cfg, Bs, P, dev, 1,
                                               seed=25)[0].items()
              if k != "labels"}
    pre = make_prefill_step(cfg, rt, cache_size=P + gen)
    pre0 = make_prefill_step(cfg, rt0, cache_size=P + gen)
    dec, dec0 = make_decode_step(cfg, rt), make_decode_step(cfg, rt0)
    pt = sharding.distribute_tree(
        prompt, sharding.batch_specs(prompt, rt.sc, Bs), dm)
    same, ties, cache, _ = _greedy_vs_plain(
        pre, pre0, dec, dec0, state["params"], state0["params"], pt, prompt,
        P, gen)
    specs_c = dict(sharding._spec_items(sharding.cache_specs(
        cache, cfg, rt.sc, Bs)))
    misplaced = [p for p, t in tree_items(cache) if tuple(t.placements)
                 != tuple(sharding.to_placements(specs_c[p], dm))]
    log(f"[mesh-family] {tag} bf16 B={Bs} prompt {P}, {gen} greedy tokens "
        f"on the mesh: {same} of {gen + 1} token rows equal to the plain "
        f"path's, {ties} near-ties; cache leaves {len(specs_c)}, "
        f"{len(misplaced)} off cache_specs' placements; placements "
        + str(sorted({f'{p[-1]}: {t.placements}'
                      for p, t in tree_items(cache)})))
    if misplaced:
        raise AssertionError(f"{tag}: cache leaves off cache_specs: "
                             f"{misplaced[:4]}")
    del state, state0, cache
    torch.cuda.empty_cache()


def family_mesh_path(dev):
    """Phase 24: olmoe-1b-7b (expert-parallel layout), jamba-v0.1-52b,
    xlstm-1.3b and whisper-large-v3 at full width, depth cut
    (``family_cut``), on a one-rank NCCL ``DeviceMesh`` (data=1, model=1)
    with DTensor state beside each one's plain twin from the same state, in
    bf16 with remat none: (a) ``MESH_FAMILY_STEPS`` AdamW steps, losses,
    grad norms and (for olmoe) the MoE auxiliaries within phase 11's
    tolerances, each kernel's launches per DTensor step one forward and one
    backward a layer of its mixer (``family_launches``; counters set to 0
    just before each DTensor step and read just after: the kernels run on
    each rank's shard through ``local_map``); (b) a prefill and
    ``MESH_FAMILY_GEN`` greedy tokens with a DTensor cache, tokens equal to
    the plain path's but on near-ties and every cache leaf in
    ``cache_specs``' placements; (c) each step's wall and own peak beside
    the plain step's; (d) the dry runs of ``FAMILY_DRYRUN_CELLS`` in CPU
    subprocesses, started first.  Returns the launches of the DTensor
    steps."""
    t0 = time.perf_counter()
    procs = _dryrun_procs(FAMILY_DRYRUN_CELLS, tag="phase24")
    counts: dict = {}
    with _one_rank_mesh(dev) as dm:
        for F in MESH_FAMILIES:
            _family_on_mesh(F, dm, dev, counts)
            log(f"[mesh-family] {F['arch']} done at "
                f"{time.perf_counter() - t0:.1f} s")
    _dryrun_wait(procs, t0, phase=24)
    log(f"[mesh-family] phase 24 took {time.perf_counter() - t0:.1f} s; "
        f"launches of the DTensor steps {counts}")
    return counts


# --------------------------------------------------------------------------- #
# phase 25: attention split over its keys or its query rows
# --------------------------------------------------------------------------- #
# heads that do not divide a 16-wide model axis, at full width in bf16
# (tag, B, Sq, Sk, H, KV, hd, causal, dtype): smollm-135m's training shape
# (9 / 3 heads of 64), yi-34b's width (56 / 8 of 128), whisper-large-v3's
# encoder (20 heads of 64 over 1500 frames: shards of 94 and one of 90), its
# decoder's cross-attention (64 queries against the 1500 frames), and a
# 100-token prompt of smollm-135m, which DTensor's split leaves the last rank
# no rows and no keys (14 x 7 + 2 + 0): that rank launches nothing and its
# dk, dv (qseq) and dq (kvseq) shares are zero
FALLBACK_RANKS = 16
FALLBACK_SHAPES = [
    ("smollm-135m train", 8, 1024, 1024, 9, 3, 64, True, torch.bfloat16),
    ("smollm-135m 100-token prompt", 8, 100, 100, 9, 3, 64, True,
     torch.bfloat16),
    ("yi-34b width", 1, 4096, 4096, 56, 8, 128, True, torch.bfloat16),
    ("whisper-large-v3 encoder", 2, 1500, 1500, 20, 20, 64, False,
     torch.bfloat16),
    ("whisper-large-v3 cross", 8, 64, 1500, 20, 20, 64, False,
     torch.bfloat16),
]


def fallback_pieces(fallback, q, k, v, dout, causal, ranks=FALLBACK_RANKS):
    """Each rank's work of one split attention call, rank after rank on
    this card, through the functions that the mesh path's autograd
    Function (``attention._SplitAttention``) calls: (forward pieces,
    merge, backward pieces), each a list of thunks or one thunk.  kvseq:
    ``kvseq_piece`` on each rank's keys, ``kvseq_combine``, ``piece_bwd``
    given the merged output and log-sum-exp; qseq: ``qseq_piece`` on each
    rank's rows, its rows concatenated, ``piece_bwd`` on them.  Every call
    takes ``shard_offset``'s diagonal; a rank that ``attention.spans``
    leaves no rows or keys launches nothing."""
    Sq, Sk = q.shape[1], k.shape[1]
    if fallback == "kvseq":
        shards = [(k[:, a:b].contiguous(), v[:, a:b].contiguous(),
                   attention.shard_offset("kvseq", a, Sq, Sk))
                  for a, b in attention.spans(Sk, ranks)]
        fwd = [functools.partial(attention.kvseq_piece, q, kr, vr, causal,
                                 off) for kr, vr, off in shards]

        def merge(parts):
            out, lse = attention.kvseq_combine(
                torch.stack([p[0] for p in parts]),
                torch.stack([p[1] for p in parts]), attention.stacked_reduce)
            return out[0], lse[0]

        def bwd(out, lse):
            return [functools.partial(attention.piece_bwd, q, kr, vr, out,
                                      lse, dout, causal, off)
                    for kr, vr, off in shards]
        return fwd, merge, bwd
    bounds = attention.spans(Sq, ranks)
    rows = [(q[:, a:b].contiguous(), dout[:, a:b].contiguous(),
             attention.shard_offset("qseq", a, Sq, Sk)) for a, b in bounds]
    fwd = [functools.partial(attention.qseq_piece, qr, k, v, causal, off)
           for qr, _, off in rows]

    def merge(parts):
        return (torch.cat([p[0] for p in parts], 1),
                torch.cat([p[1] for p in parts], 2))

    def bwd(out, lse):
        return [functools.partial(
            attention.piece_bwd, qr, k, v, out[:, a:b].contiguous(),
            lse[:, :, a:b].contiguous(), dr, causal, off)
            for (qr, dr, off), (a, b) in zip(rows, bounds)]
    return fwd, merge, bwd


def fallback_call(fallback, q, k, v, dout, causal):
    """One split call: (out, lse, dq, dk, dv), the gradients summed over
    the ranks where a rank holds a share (kvseq's dq, qseq's dk and dv;
    in fp32) and concatenated where it holds whole rows."""
    fwd, merge, bwd = fallback_pieces(fallback, q, k, v, dout, causal)
    out, lse = merge([f() for f in fwd])
    grads = [b() for b in bwd(out, lse)]
    if fallback == "kvseq":
        return (out, lse, sum(g[0].float() for g in grads),
                torch.cat([g[1] for g in grads], 1),
                torch.cat([g[2] for g in grads], 1))
    return (out, lse, torch.cat([g[0] for g in grads], 1),
            sum(g[1].float() for g in grads),
            sum(g[2].float() for g in grads))


def fallback_path(dev):
    """Phase 25: each ``FALLBACK_SHAPES`` attention split 16 ways over its
    keys (kvseq) and over its query rows (qseq), each rank's work run in
    turn on this card through the functions the mesh path calls
    (``fallback_pieces``; the card's one-rank mesh never meets heads that
    do not divide it).  The merged output, log-sum-exp and gradients are
    held against the plain version at phase 2's bf16 tolerances and
    against the one-call kernels at twice the bf16 term (both sides round
    to bf16, the split once per piece and again in the merge); each split
    call launches the forward and backward kernels once for each rank with
    rows and keys, 16 times each where no rank is empty (counters set to 0
    just before, read just after); the pieces'
    summed kernel time is printed beside the one call's.  Returns the
    launches of the split calls."""
    t0 = time.perf_counter()
    total = {"flash_attention": 0, "flash_attention_bwd": 0}
    for shape in FALLBACK_SHAPES:
        tag, B, Sq, Sk, H, KV, hd, causal, dtype = shape
        q, k, v = flash_inputs(shape, dev)
        g = torch.Generator(device=dev).manual_seed(1)
        dout = torch.randn(q.shape, generator=g, device=dev).to(dtype)
        out1, lse1 = flash_ops.forward(q, k, v, causal, with_lse=True)
        one = (out1, lse1) + flash_ops.backward(q, k, v, out1, lse1, dout,
                                                causal)
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        plain_out = flash_ref.attention_ref(*xs, causal=causal)
        plain = ((plain_out.detach(),
                  flash_ref.attention_lse_ref(q, k, v, causal=causal)[1])
                 + torch.autograd.grad(plain_out, xs, dout))
        del xs, plain_out
        scale = [float(t.float().abs().max()) for t in plain]
        tol = [2e-5 + 2.0 ** -7 * scale[0], FLASH_BWD_RTOL * scale[1]] + [
            (FLASH_BWD_RTOL + FLASH_BWD_RTOL_BF16) * s for s in scale[2:]]
        tol_one = [tol[0] + 2.0 ** -7 * scale[0], tol[1]] + [
            t + FLASH_BWD_RTOL_BF16 * s for t, s in zip(tol[2:], scale[2:])]
        t_one = (cuda_ms(lambda: flash_ops.forward(q, k, v, causal,
                                                   with_lse=True), 5),
                 cuda_ms(lambda: flash_ops.backward(q, k, v, out1, lse1,
                                                    dout, causal), 5))
        for fallback in ("kvseq", "qseq"):
            for name in flash_ops.launches:
                flash_ops.launches[name] = 0
            got = fallback_call(fallback, q, k, v, dout, causal)
            torch.cuda.synchronize()
            n = dict(flash_ops.launches)
            bad = []
            for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
                if bool(torch.isnan(got[i]).any()):
                    bad.append(f"{name} NaN")
                e_plain = _max_err(got[i].float(), plain[i].float())
                e_one = _max_err(got[i].float(), one[i].float())
                ok = e_plain <= tol[i] and e_one <= tol_one[i]
                log(f"[fallback] {tag} {fallback} {name}: vs plain "
                    f"{e_plain:.3e} (tol {tol[i]:.3e}), vs one call "
                    f"{e_one:.3e} (tol {tol_one[i]:.3e}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append(name)
            held = sum(b > a for a, b in attention.spans(
                Sq if fallback == "qseq" else Sk, FALLBACK_RANKS))
            want_n = {"flash_attention": held, "flash_attention_bwd": held}
            if n != want_n:
                bad.append(f"launches {n}")
            if bad:
                raise AssertionError(f"fallback {tag} {fallback}: {bad}")
            for name in total:
                total[name] += n[name]
            fwd, merge, bwd = fallback_pieces(fallback, q, k, v, dout,
                                              causal)
            parts = [f() for f in fwd]
            t_fwd = sum(cuda_ms(f, 5) for f in fwd)
            t_merge = cuda_ms(lambda: merge(parts), 5)
            t_bwd = sum(cuda_ms(b, 5) for b in bwd(got[0], got[1]))
            log(f"[fallback] {tag} {fallback}: launches {n}; {held} pieces "
                f"forward {t_fwd:.4f} ms + merge {t_merge:.4f} ms, backward "
                f"{t_bwd:.4f} ms; one call forward {t_one[0]:.4f} ms, "
                f"backward {t_one[1]:.4f} ms")
            del got, parts
        del q, k, v, dout, one, plain, out1, lse1
        torch.cuda.empty_cache()
    log(f"[fallback] phase 25 took {time.perf_counter() - t0:.1f} s; "
        f"launches of the split calls {total}")
    return total


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    start = time.perf_counter()

    def wall(phases):
        log(f"[wall] phases {phases} done at "
            f"{time.perf_counter() - start:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[setup] {card}")
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    # one nvcc per suite, started together
    suites = (("gp_acquisition", ops), ("tpe_kde", tpe_ops),
              ("flash_attention", flash_ops), ("mlstm_chunk", mlstm_ops),
              ("ssm_scan", ssm_ops))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(suites)) as pool:
        lib, _, _, _, ssm_lib = [f.result() for f in [
            pool.submit(mod.library) for _, mod in suites]]
    log("[setup] built " + ", ".join(
        str(build.library_path(name, mod.SOURCES)) for name, mod in suites)
        + f" in {time.perf_counter() - t0:.1f} s")
    for name, mod in suites:
        for line in build.ptxas_report(name, mod.SOURCES).splitlines():
            if "ptxas" in line:
                log(f"[setup] {name}: {line.strip()}")
    for hd in (32, 64, 96, 128):
        log(f"[setup] flash_attention at hd {hd}, per kernel (registers per "
            "thread, spill bytes per thread, shared memory bytes per block): "
            + ", ".join(f"{name} {a}" for name, a in
                        flash_ops.kernel_attrs(hd).items()))
    log("[setup] mlstm_chunk stage kernels (registers per thread, spill "
        "bytes per thread, shared memory bytes per block): "
        + ", ".join(f"{name} {a}" for name, a in
                    mlstm_ops.kernel_attrs().items()))
    log("[setup] ssm_scan backward dynamic shared memory per block at N "
        "8/16/32: " + "/".join(str(ssm_lib.ssm_scan_bwd_smem_bytes(n))
                               for n in (8, 16, 32)) + " bytes")
    log("[setup] TPE kernels at R candidates per thread (registers per "
        "thread, spill bytes per thread, static shared memory bytes per "
        "block): "
        + ", ".join(f"{name} {a}" for name, a in
                    tpe_ops.kernel_attrs().items()))
    log("[setup] score_cov kernels (registers per thread, spill bytes per "
        "thread, static shared memory bytes per block): "
        + ", ".join(f"{name} {a}" for name, a in ops.kernel_attrs().items()))
    for na, dp in ((16, 24), (32, 8), (256, 8), (256, 64), (512, 8),
                   (1024, 8)):
        blocks = ctypes.c_int(0)
        err = lib.gp_score_cov_blocks_per_sm(na, dp, ctypes.byref(blocks))
        if err:
            raise RuntimeError(lib.gp_error_string(err).decode())
        log(f"[setup] score_cov dynamic shared memory at na={na} dp={dp}: "
            f"{lib.gp_score_cov_smem_bytes(na, dp)} bytes "
            "(negative: K streamed from global memory), "
            f"{blocks.value} blocks per SM (occupancy calculator)")
    recs = check_kernels(dev, reps_main=20)
    recs.update(check_fit_kernels(dev, reps_main=20))
    recs.update(check_tpe_kernels(dev, reps_main=20))
    recs["flash_attention"] = check_flash_kernel(dev, reps_main=20)
    recs.update(check_mlstm_kernels(dev, reps_main=10))
    recs.update(check_ssm_kernels(dev, reps_main=10))
    recs["flash_attention_bwd"] = check_flash_bwd_kernel(dev, reps_main=10)
    check_flash_offsets(dev, recs)
    wall("1-2")
    bank, launches = fleet_path(dev)
    tpe_bank, launches["tpe_scores"] = tpe_fleet_path(dev)
    launches["parzen_logdens"] = parzen_path(dev)
    mixed_fleet_path(dev)
    tuner_path(dev)
    fig3_tpe_path(dev)
    parity_path(bank, "gp", oracle_judge(gp_oracle), "bank_absorb")
    parity_path(tpe_bank, "tpe", oracle_judge(tpe_oracle),
                "joined to the bad split")
    wall("3-7")
    launches["flash_attention"] = serve_path(dev)
    serve_parity_path(dev)
    if "--profile" in argv:
        profile_path(bank, tpe_bank)
        profile_serve(dev)
    del bank, tpe_bank
    torch.cuda.empty_cache()
    wall("8-9")
    counts = train_path(dev)
    launches["mlstm_chunk"] = counts["mlstm_chunk"]
    launches["mlstm_chunk_bwd"] = counts["mlstm_chunk_bwd"]
    train_parity_path(dev)
    xlstm_serve_path(dev)
    if "--profile" in argv:
        profile_train(dev)
    torch.cuda.empty_cache()
    wall("10-12")
    counts = jamba_train_path(dev)
    for name in ("ssm_scan", "ssm_scan_bwd", "flash_attention_bwd"):
        launches[name] = counts[name]
    jamba_parity_path(dev)
    jamba_serve_path(dev)
    if "--profile" in argv:
        profile_jamba_train(dev)
    torch.cuda.empty_cache()
    wall("13-15")
    launches["flash_attention"] += whisper_serve_path(dev)
    counts = whisper_train_path(dev)
    for name in ("flash_attention", "flash_attention_bwd"):
        launches[name] += counts[name]
    whisper_parity_path(dev)
    wall("16-18")
    launches["score_cov"] += cluster_fleet_path(dev)
    wall("19")
    process_scheduler_path(dev)
    fault_queue_path(dev)
    counts = service_path(dev)
    for name in ("score_cov", "var_downdate", "tpe_scores"):
        launches[name] += counts[name]
    chaos_path(dev)
    wall("20")
    for counts in (single_study_path(dev), ref_tuner_path(dev),
                   examples_path(dev)):
        for name in ("score_cov", "var_downdate", "tpe_scores"):
            launches[name] += counts.get(name, 0)
    wall("21")
    for counts in (sanitizer_smoke_path(dev), sanitizer_fleet_path(dev)):
        for name in ("score_cov", "var_downdate", "tpe_scores"):
            launches[name] += counts.get(name, 0)
    wall("22")
    counts = mesh_path(dev)
    for name in ("flash_attention", "flash_attention_bwd"):
        launches[name] += counts[name]
    wall("23")
    for name, n in family_mesh_path(dev).items():
        launches[name] += n
    wall("24")
    for name, n in fallback_path(dev).items():
        launches[name] += n
    wall("25")
    gp_src = "src/repro_torch/kernels/gp_acquisition/csrc/gp_acquisition.cu"
    fit_src = "src/repro_torch/kernels/gp_acquisition/csrc/fit_grad.cu"
    tpe_src = "src/repro_torch/kernels/tpe_kde/csrc/tpe_kde.cu"
    flash_src = ("src/repro_torch/kernels/flash_attention/csrc/"
                 "flash_attention.cu")
    mlstm_src = "src/repro_torch/kernels/mlstm_chunk/csrc/"
    mlstm_tpu = "src/repro/kernels/mlstm_chunk/mlstm_chunk.py:90"
    ssm_src = "src/repro_torch/kernels/ssm_scan/csrc/"
    ssm_tpu = "src/repro/kernels/ssm_scan/ssm_scan.py:60"
    flash_tpu = "src/repro/kernels/flash_attention/flash_attention.py:90"
    where = {
        "score_cov": (gp_src, "src/repro/kernels/gp_acquisition/"
                              "gp_acquisition.py:84"),
        "var_downdate": (gp_src, "src/repro/kernels/gp_acquisition/"
                                 "gp_acquisition.py:157"),
        "masked_kernel": (fit_src, "none (XLA fuses the JAX fit's K)"),
        "fit_grad": (fit_src, "none (jax.grad under XLA)"),
        "tpe_scores": (tpe_src, "src/repro/kernels/tpe_kde/tpe_kde.py:70"),
        "parzen_logdens": (tpe_src,
                           "src/repro/kernels/tpe_kde/tpe_kde.py:114"),
        "flash_attention": (flash_src, flash_tpu),
        "mlstm_chunk": (mlstm_src + "mlstm_chunk.cu", mlstm_tpu),
        "mlstm_chunk_bwd": (mlstm_src + "mlstm_chunk_bwd.cu", mlstm_tpu),
        "ssm_scan": (ssm_src + "ssm_scan.cu", ssm_tpu),
        "ssm_scan_bwd": (ssm_src + "ssm_scan_bwd.cu", ssm_tpu),
        "flash_attention_bwd": (flash_src.replace(".cu", "_bwd.cu"),
                                flash_tpu)}
    kernels = [dict(name=name, route="cuda", source=where[name][0],
                    replaces=where[name][1], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"],
                    library_ms=r.get("library_ms"))
               for name, r in recs.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
