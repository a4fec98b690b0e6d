"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see README.md.
Everything here but :mod:`chipbench.program` is the yardstick and imports
nothing of the port: the traffic generator, the weights, the plain
reference, the FLOP and byte formulas, the peaks and the comparison that
decides ``correct``.
"""
