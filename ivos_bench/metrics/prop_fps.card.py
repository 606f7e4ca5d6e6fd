"""`prop_fps` in the card-paced cells, which report `prop_fps.card`: the same
reading as metrics/prop_fps.py."""
from ivos_bench.metrics.prop_fps import read  # noqa: F401
