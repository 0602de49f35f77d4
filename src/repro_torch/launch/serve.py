"""Batched serving: prefill a prompt batch, then greedy decode.

The counterpart of ``python -m repro.launch.serve``.  It runs on the card
unless ``--device cpu`` is given, where every kernel runs its plain
version; without a card the default device raises.  On the card prefill
attention runs the flash-attention kernel and a Mamba layer's prefill the
scan kernel (which also returns the final state); xLSTM serves through its
plain stateful forms, and decode is plain PyTorch throughout.  A Python
caller may pass its own ``ArchConfig`` to ``run`` (``cfg=``), e.g. a config
cut in depth; ``--arch`` then only names it.  Parameters are random, drawn from
a ``torch.Generator`` seeded with ``--seed`` on the device; prompt tokens
(and a VLM's stub patch embeddings, or whisper's stub frame embeddings)
come from ``numpy.random.default_rng`` with the same seed.  Whisper's
prefill encodes the frames and caches each decoder layer's cross keys and
values; decode reads them.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --batch 8 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 \\
      --batch 8 --prompt-len 64 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mlstm_chunk import ops as mlstm_ops
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models.common import Runtime
from repro_torch.models.transformer import init_params
from repro_torch.train.step import make_decode_step, make_prefill_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, cfg=None) -> dict:
    """Serve one batch of ``args.arch`` (or of ``cfg``); returns the JAX
    package's keys (``prefill_s``, ``decode_s``, ``decode_tok_s``,
    ``generated_shape``, ``sample``), the flash-attention, Mamba-scan and
    mLSTM kernel launches of each stage (the mLSTM kernel serves no stage:
    prefill and decode carry state, which its kernel path does not return,
    as in the reference) and whether every logit was finite."""
    dev = resolve_device(args.device)
    cfg = cfg or get_config(args.arch, reduced=args.reduced)
    dt = torch.float32 if args.fp32 else torch.bfloat16
    rt = Runtime(param_dtype=dt, compute_dtype=dt)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(gen, cfg, rt)

    B, P = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, P), dtype=np.int32), device=dev)}
    total = P + args.gen
    if cfg.vision_tokens:
        batch["patches"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model), dtype=np.float32),
            device=dev).to(rt.compute_dtype)
        total += cfg.vision_tokens
    if cfg.encoder_layers:
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model), dtype=np.float32),
            device=dev).to(rt.compute_dtype)

    prefill = make_prefill_step(cfg, rt, cache_size=total)
    decode = make_decode_step(cfg, rt)

    def count():
        return (flash_ops.launches["flash_attention"],
                mlstm_ops.launches["mlstm_chunk"],
                ssm_ops.launches["ssm_scan"])

    n0 = count()

    _sync(dev)
    t0 = time.perf_counter()
    tok, cache, logits = prefill(params, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    n1 = count()

    out_tokens = [tok]
    finite = torch.isfinite(logits).all()
    pos0 = P + cfg.vision_tokens
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        tok, cache, logits = decode(params, tok[:, None], cache, pos0 + i)
        out_tokens.append(tok)
        finite &= torch.isfinite(logits).all()
    _sync(dev)
    t_decode = time.perf_counter() - t0
    n2 = count()

    gen_tokens = torch.stack(out_tokens, dim=1).cpu().numpy()
    return {
        "arch": args.arch,
        "device": str(dev),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_s": B * (args.gen - 1) / max(t_decode, 1e-9),
        "generated_shape": list(gen_tokens.shape),
        "sample": gen_tokens[0, :10].tolist(),
        "flash_launches": {"prefill": n1[0] - n0[0],
                           "decode": n2[0] - n1[0]},
        "mlstm_launches": {"prefill": n1[1] - n0[1],
                           "decode": n2[1] - n1[1]},
        "ssm_launches": {"prefill": n1[2] - n0[2],
                         "decode": n2[2] - n1[2]},
        "logits_finite": bool(finite),
    }


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


if __name__ == "__main__":
    print(json.dumps(run(make_parser().parse_args()), indent=2))
