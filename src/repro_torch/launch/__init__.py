"""Entry points: the training driver (``train.py``)."""
