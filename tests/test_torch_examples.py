"""PyTorch port, the examples (``repro_torch.examples``): each ``main`` runs
in-process on the CPU at a tiny size (two iterations; the training tuner on
the reduced smollm for a few steps), and by default asks for the card."""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import math

import pytest
import torch

from repro_torch.examples import (distributed_tuning, quickstart,
                                  serve_batched, tune_training)

EXAMPLES = (quickstart, distributed_tuning, serve_batched, tune_training)


def test_quickstart():
    res = quickstart.main(["--device", "cpu", "--iterations", "2"])
    assert len(res.objective_values) == 2 + 2 * 3
    assert 0.5 < res.best_objective <= 1.0
    assert set(res.best_params) == {"C", "gamma"}


def test_distributed_tuning():
    """The sync tuner over the fault-injecting queue observes what made the
    deadline and counts the rest as failed; the async tuner completes its
    evaluations."""
    out = distributed_tuning.main(["--device", "cpu", "--iterations", "2",
                                   "--evals", "12"])
    sync, asy = out["sync"], out["async"]
    assert len(sync.objective_values) + sync.n_failed == 2 + 2 * 8
    assert 0.5 < sync.best_objective <= 1.0
    assert len(asy.objective_values) + asy.n_failed == 12


def test_serve_batched():
    out = serve_batched.main(["--device", "cpu"])
    assert out["generated_shape"] == [4, 12] and out["logits_finite"]


def test_tune_training():
    res = tune_training.main(["--device", "cpu", "--iterations", "2",
                              "--batch", "1", "--trial-steps", "2"])
    assert len(res.objective_values) == 2 + 2
    assert all(math.isfinite(v) for v in res.objective_values)


@pytest.mark.parametrize("mod", EXAMPLES, ids=lambda m: m.__name__)
def test_examples_default_to_the_card(mod):
    """Without ``--device`` an example runs on ``cuda``; without a card it
    raises instead of running on the CPU."""
    assert mod.make_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([] if mod is not tune_training else
                     ["--iterations", "0"])
