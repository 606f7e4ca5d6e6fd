"""`peak_mem_gib` in the card-paced cells, which report `prop_fps.card`: the same
reading as metrics/peak_mem_gib.py."""
from ivos_bench.metrics.peak_mem_gib import read  # noqa: F401
