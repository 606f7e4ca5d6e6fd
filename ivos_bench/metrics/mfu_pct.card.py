"""`mfu_pct` in the card-paced cells, which report `prop_fps.card`: the same
reading as metrics/mfu_pct.py."""
from ivos_bench.metrics.mfu_pct import read  # noqa: F401
