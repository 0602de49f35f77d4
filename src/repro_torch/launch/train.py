"""End-to-end training driver.

The counterpart of ``python -m repro.launch.train``, with the same flags
(``--pallas`` dropped: on the card the kernels always run; ``--device``
added).  It runs on the card unless ``--device cpu`` is given, where every
kernel runs its plain version; without a card the default device raises.
Parameters are random, drawn from a ``torch.Generator`` seeded with
``--seed`` on the device; batches come from the synthetic Markov pipeline
(``--data-seed``), bit for bit the JAX package's.  Every config trains.
Whisper's batch also needs stub frame embeddings (B, encoder_seq, d), which
the JAX package's driver does not supply; here they are standard normal
draws from a numpy stream seeded by ``--data-seed`` and the step
(``frames_at``), so a resumed run sees the same frames.  A Python caller
may pass its own ``ArchConfig`` to ``run`` (``cfg=``), e.g. a config cut in
depth; ``--arch`` then only names it.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-1.3b \\
      --batch 2 --seq 1024 --steps 4 --remat none
  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \\
      --reduced --device cpu --steps 20 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch whisper-large-v3 --batch 4 --seq 448 --steps 4

The printed JSON holds the reference's keys (``final_loss``,
``first_loss``, ``n_params``, ``wall_s``) and the port's own: per step the
grad norm, the host-clock step time (ended by a synchronize), the share of
MoE token slots dropped at capacity (summed over MoE layers, as the
reference sums it), and the launches of each kernel entry point, forward and backward (mLSTM, the
Mamba scan, flash attention), tokens per second, and the peak device
memory.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models.common import Runtime
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.step import (TrainHyper, init_train_state,
                                    make_train_step)
from repro_torch.tree import tree_leaves


# per-step launch records: (record key, counter dict, forward entry point,
# backward entry point)
LAUNCH_RECORDS = (
    ("mlstm_launches", mlstm_ops.launches, "mlstm_chunk", "mlstm_chunk_bwd"),
    ("ssm_launches", ssm_ops.launches, "ssm_scan", "ssm_scan_bwd"),
    ("flash_launches", flash_ops.launches, "flash_attention",
     "flash_attention_bwd"))


def build(args, cfg=None):
    cfg = cfg or get_config(args.arch, reduced=args.reduced)
    dt = torch.float32 if args.fp32 else torch.bfloat16
    rt = Runtime(param_dtype=dt, compute_dtype=dt,
                 ce_chunk=min(args.seq, 512), ssm_chunk=min(args.seq, 256),
                 remat_policy=args.remat)
    hyper = TrainHyper(
        opt=AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                        total_steps=args.steps,
                        weight_decay=args.weight_decay),
        grad_compression=args.grad_compression)
    return cfg, rt, hyper


def frames_at(data_seed: int, step: int, batch: int,
              cfg) -> np.ndarray:
    """Step ``step``'s stub frame embeddings (batch, encoder_seq, d),
    float32, a pure function of (data_seed, step)."""
    rng = np.random.default_rng((data_seed, step, 1))
    return rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model),
                               dtype=np.float32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, cfg=None) -> dict:
    """Train for ``args.steps`` steps of ``args.arch`` (or of ``cfg``)."""
    dev = resolve_device(args.device)
    cfg, rt, hyper = build(args, cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, global_batch=args.batch,
                                  seed=args.data_seed))
    state = init_train_state(torch.Generator(device=dev).manual_seed(
        args.seed), cfg, rt, grad_compression=hyper.grad_compression)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    start_step = 0
    ckpt = Checkpointer(args.ckpt_dir, cfg, keep=3) if args.ckpt_dir \
        else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, meta = ckpt.restore(None, state)
        start_step = meta["step"]
        data.restore(meta["data_state"])
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, rt, hyper, n_microbatches=args.micro)
    log_path = Path(args.log) if args.log else None
    rec = {k: [] for k in ("losses", "grad_norms", "step_s", "moe_drop_frac",
                           *(r[0] for r in LAUNCH_RECORDS))}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch_at(step).items()}
        if cfg.encoder_layers:
            batch["frames"] = torch.as_tensor(
                frames_at(args.data_seed, step, args.batch, cfg),
                device=dev).to(rt.compute_dtype)
        data.step = step + 1
        n0 = [dict(r[1]) for r in LAUNCH_RECORDS]
        _sync(dev)
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        _sync(dev)
        rec["step_s"].append(time.perf_counter() - ts)
        for (key, counts, fwd, bwd), c0 in zip(LAUNCH_RECORDS, n0):
            rec[key].append({"forward": counts[fwd] - c0[fwd],
                             "backward": counts[bwd] - c0[bwd]})
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        rec["losses"].append(loss)
        rec["grad_norms"].append(gnorm)
        rec["moe_drop_frac"].append(float(metrics["moe_drop_frac"]))
        if log_path:
            with open(log_path, "a") as f:
                f.write(json.dumps(
                    {"step": step, "loss": loss, "ce": float(metrics["ce"]),
                     "grad_norm": gnorm, "lr": float(metrics["lr"])}) + "\n")
        if args.verbose and (step % args.print_every == 0
                             or step == args.steps - 1):
            tok_s = (args.batch * args.seq * (step - start_step + 1)
                     / max(time.time() - t0, 1e-9))
            print(f"step {step:5d} loss {loss:7.4f} gnorm {gnorm:8.3f} "
                  f"lr {float(metrics['lr']):.2e} tok/s {tok_s:,.0f}",
                  flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state,
                      extra={"data_state": data.state(), "arch": args.arch,
                             "loss": loss})
    losses = rec["losses"]
    if ckpt:
        ckpt.save(args.steps, state, extra={"data_state": data.state(),
                                            "arch": args.arch,
                                            "loss": losses[-1]})
        ckpt.wait()
    wall = time.time() - t0
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "n_params": n_params,
            "wall_s": wall,
            "device": str(dev),
            "tokens_per_s": args.batch * args.seq * len(losses)
            / max(sum(rec["step_s"]), 1e-9),
            "peak_mem_gib": peak,
            **rec}


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--weight-decay", type=float, default=0.1)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=1234)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log", default="")
    ap.add_argument("--print-every", type=int, default=10)
    ap.add_argument("--verbose", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


if __name__ == "__main__":
    out = run(make_parser().parse_args())
    print(json.dumps({k: v for k, v in out.items() if k != "losses"}))
