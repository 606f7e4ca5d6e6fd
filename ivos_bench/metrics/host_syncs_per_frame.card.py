"""`host_syncs_per_frame` in the card-paced cells, which report `prop_fps.card`: the same
reading as metrics/host_syncs_per_frame.py."""
from ivos_bench.metrics.host_syncs_per_frame import read  # noqa: F401
