"""One reader per metric, found by the metric's name (``transfer_ms.serve``
reads ``transfer_ms.serve.py`` if there is one, else ``transfer_ms.py``):
``read(run) -> float | None``, None where the run holds nothing to read."""
