"""Sharded, digest-verified checkpoints (``store.py``)."""
