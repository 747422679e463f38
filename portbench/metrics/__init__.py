"""One reader a per-layer metric, ``metrics/<name>.py``, each with
``read(run) -> float | None``: ``None`` where the run holds nothing to
read, and the harness then leaves the metric out."""
