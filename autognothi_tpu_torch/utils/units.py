"""Unit type aliases used by the measurement reports (the port's copy of
`autognothi_tpu/utils/units.py`)."""

Seconds = float
GFLOPS = float
MParams = float
MiBytes = float
