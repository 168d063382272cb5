"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once.  The modules here are
the yardstick: the traffic generator (``traffic``), the weights made from
the seed (``weights``), the drivers of a training and a serving cell
(``train``, ``serve``), the reading of the profiler's window (``trace``),
the model FLOP formulas (``flops``), the operations and bytes of the flash
kernel (``work``), the kinds of device work (``kinds``), the chip's peaks
(``peaks``) and the comparison that decides ``correct`` (``check``).  Only
``port`` imports the program.
"""
