"""`read_roofline` in the card-paced cells, which report `prop_fps.card`: the same
reading as metrics/read_roofline.py."""
from ivos_bench.metrics.read_roofline import read  # noqa: F401
