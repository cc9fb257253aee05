"""Fault tolerance: heartbeats, the restarting supervisor (``supervisor.py``)."""
