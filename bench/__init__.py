"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one cell
(a model configuration under a traffic mix) per run of ``bench/run.py``.

Everything a cell needs is found by name from ``BENCHMARK.json``:
``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json``, one
reader per metric, ``bench/metrics/<metric>.py``, and by the
configuration's ``family`` and ``reference`` keys its model family,
``bench/families/<family>.py``, and its plain reference,
``bench/reference/<reference>.py``.  Only ``program.py`` imports the
port; nothing here imports JAX or the JAX package.
``parked.json`` holds the entries of cells kept out of ``BENCHMARK.json``
(their runs spread wider than a bound allows): the tests run them, a run
never reads it.
"""
