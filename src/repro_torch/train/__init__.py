"""Training: pure optimizers on dicts of tensors (``optim.py``), the train
step (``step.py``) and the nested-dict helpers they share (``tree.py``)."""
