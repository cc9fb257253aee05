"""Frozen copies of the program's cost arithmetic, the chip's peaks and the
closed-form model FLOPs (``model_flops.py``, with one ``flops_<family>.py``
a family): the yardstick of every roofline share and of ``mfu``. A later
change to the program's own functions does not move these."""
