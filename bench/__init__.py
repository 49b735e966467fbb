"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): the
manifest is ``BENCHMARK.json`` at the root; ``python3 -m bench.run`` runs
one of its cells on the card (``bench/run.py``)."""
