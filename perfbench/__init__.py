"""The benchmark of ``repro_torch`` on an NVIDIA H100 (see ``run.py``)."""
