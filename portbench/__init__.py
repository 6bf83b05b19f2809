"""The benchmark of the PyTorch and CUDA port (``loner_tpu_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Everything
that belongs to one configuration, traffic mix or per-layer metric is a file of
its own, found by the name ``BENCHMARK.json`` gives: ``configs/<config>.json``,
``traffic/<traffic>.json`` (which names its generator in ``drivers/``),
``metrics/<metric>.py`` and ``limits/<cell>.json``. ``reference/`` is the plain
PyTorch reference that decides ``correct``; it imports nothing of the port.
"""
