"""The JAX package's examples on the port, as modules:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.distributed_tuning [--device cpu]
    python -m repro_torch.examples.serve_batched [--device cpu]
    python -m repro_torch.examples.tune_training [--device cpu]

Each takes the reference script's flags plus ``--device`` (``cuda`` by
default; ``cpu`` runs the plain PyTorch versions) and exposes
``main(argv)``, which returns its result.
"""
