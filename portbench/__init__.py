"""The benchmark of the PyTorch/CUDA port (``unified_audio_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace 0|1`` runs one cell of ``BENCHMARK.json`` once on the CUDA card
and prints one JSON line. Everything that belongs to one configuration,
cell, driver, per-layer metric or reference sits in a file of its own,
found by name (``harness/manifest.py``).
"""
