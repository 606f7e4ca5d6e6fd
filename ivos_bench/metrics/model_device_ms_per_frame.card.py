"""`model_device_ms_per_frame` in the card-paced cells, which report `prop_fps.card`: the same
reading as metrics/model_device_ms_per_frame.py."""
from ivos_bench.metrics.model_device_ms_per_frame import read  # noqa: F401
