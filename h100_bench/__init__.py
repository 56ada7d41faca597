"""The port's H100 benchmark: cells of ``BENCHMARK.json`` run on one card
(``run.py``), every configuration, traffic mix, adapter and metric in
files of its own."""
