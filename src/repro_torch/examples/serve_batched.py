"""Batched serving: prefill a request batch, then stream greedy decode.

The reference example's run (a reduced jamba, fp32, a batch of 4 prompts of
32 tokens, 12 generated) through ``repro_torch.launch.serve`` on the card,
or on the CPU with ``--device cpu``.

    python -m repro_torch.examples.serve_batched [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from repro_torch.launch import serve


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = make_parser().parse_args(argv)
    out = serve.run(serve.make_parser().parse_args(
        ["--arch", "jamba-v0.1-52b", "--reduced", "--batch", "4",
         "--prompt-len", "32", "--gen", "12", "--fp32",
         "--device", args.device]))
    print(f"arch={out['arch']} prefill={out['prefill_s']}s "
          f"decode={out['decode_s']}s ({out['decode_tok_s']} tok/s) "
          f"shape={out['generated_shape']}")
    assert out["generated_shape"][1] == 12
    return out


if __name__ == "__main__":
    main()
