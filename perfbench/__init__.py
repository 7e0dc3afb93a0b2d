"""The benchmark of the PyTorch and CUDA port (``bitdelta_torch``).

One command runs one cell once::

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric sits in a file of its own and is found by name:
``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<mix>.json``, ``drivers/<driver>.py`` and
``metrics/<metric>.py``. The yardstick (traffic generation, the trace
reduction, the peaks and work functions, the plain references and the
comparison that decides ``correct``) lives here too, and imports
nothing of the JAX package.
"""
