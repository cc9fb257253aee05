"""Entry points: the training loop (``train.py``) and the fleet
topology the serving router takes (``mesh.py``)."""
