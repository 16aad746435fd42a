"""Measurement tools of the port: the H100 perf lab (``perf_lab``)."""
