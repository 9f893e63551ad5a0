"""The benchmark harness of the port (see ``run.py``)."""
