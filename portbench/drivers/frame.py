"""A camera stream served frame by frame: the serving driver (serve.py) at
the traffic file's ``batch`` of 1, one frame pulled each time the pipeline
asks for one.  Its end-to-end metric is the frames' latency."""

from portbench.drivers.serve import run  # noqa: F401
