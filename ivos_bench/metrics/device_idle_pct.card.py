"""`device_idle_pct` in the card-paced cells, which report `prop_fps.card`: the same
reading as metrics/device_idle_pct.py."""
from ivos_bench.metrics.device_idle_pct import read  # noqa: F401
