"""The port's benchmark: long-study tuner fleets driven through
``repro_torch``'s ``StudyBank.ask_all``, as cells named in ``BENCHMARK.json``.

``run.py`` is the command.  A cell names a configuration
(``configs/<name>.json``), a traffic mix (``traffic/<name>.json``) and the
limits of its correctness check (``limits/<cell>.json``); each per-layer
metric is a reader in ``metrics/<name>.py``.  The yardstick (objective,
traffic generator, reference, peaks and work counts) lives here, apart from
the program, and imports neither JAX nor the JAX package.
"""
