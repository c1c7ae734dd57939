"""Benchmark of the PyTorch and CUDA port (``flair_for_aigle_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout, on the card(s) of the machine it starts on:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer metric
or kernel sits in a file of its own, found by its name (``registry.py``):

* ``configs/<config>.json``: the model configuration as it is run, its
  source, ``assumed`` and ``reduced``;
* ``traffic/<traffic>.json``: the parameters of a traffic mix, read by the
  general driver its ``kind`` names (``drivers/<kind>.py``);
* ``metrics/<metric>.py``: one reader a metric, ``read(ctx)`` returning a
  number or None;
* ``kernels/<kernel>.py``: a port kernel's name patterns and the work
  (operations and bytes) it does, counted from shapes;
* ``families/<family>.py``: an architecture family's plain reference model
  and FLOP counter;
* ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct`` in that cell.

The benchmark imports neither JAX nor the JAX package ``flair_for_aigle_tpu``
(``isolation.py``); the port is the system under test.
"""
