"""Sanitizer smoke: steady-state bank serving under both runtime guards.

``python -m repro_torch.analysis.smoke [--device cpu]`` warms a small
StudyBank into its shape bucket, then drives ask/tell rounds with

  * ``no_transfer()`` — any hidden device->host sync raises, and
  * ``no_retrace()`` — any new signature of a ``gp.BANK_ENTRY_POINTS``
    entry point, or any kernel build, raises,

so one run proves the steady-state contract (zero hidden syncs, zero new
shape buckets per warm ask) end to end, not just via unit tests.  The
port of ``repro.analysis.smoke``: the same space, bank and rounds; it
runs on ``cuda`` unless the caller passes ``device="cpu"``, where the
sync guard is not load-bearing.  Exit 0 prints PASS; any violation raises
and exits nonzero.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.device import DeviceLike


def run(n_studies: int = 4, warm_rounds: int = 3, rounds: int = 6,
        verbose: bool = True, device: DeviceLike = None) -> int:
    from scipy import stats

    from repro_torch.analysis.sanitizers import no_retrace, no_transfer
    from repro_torch.core import StudyBank

    space = {"x": stats.uniform(0, 1), "y": stats.uniform(-1, 2)}
    bank = StudyBank(space, n_studies, optimizer="bayesian", seed=0,
                     mc_samples=32, device=device)

    def objective(p):
        return -(p["x"] - 0.3) ** 2 - (p["y"] - 0.5) ** 2

    def drive(n_rounds):
        for _ in range(n_rounds):
            for b, ts in enumerate(bank.ask_all(1)):
                for t in ts:
                    bank.tell(b, t.id, objective(t.params))

    # warmup: the GP pipeline first dispatches once a study has >= 2
    # observations (round 3), meeting the bucket's signatures, building
    # the kernels and running the first hyper fit
    drive(warm_rounds)
    # audited steady state: stay inside the na=16 bucket (observations
    # stay well under 16 - pend_cap - n), so not a single new signature —
    # and not one hidden device->host sync — is allowed
    with no_transfer(device=bank.device), no_retrace():
        drive(rounds)
    if verbose:
        print(f"sanitizer smoke PASS: {rounds} steady-state ask_all "
              f"rounds x {n_studies} studies on {bank.device} under "
              "no_transfer() + no_retrace()")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.smoke")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
