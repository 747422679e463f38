"""One runner a kind of cell (``train``, ``serve``), found by the ``kind``
of the cell's file under ``portbench/workloads/``."""
