"""The traffic generators, one a kind of traffic mix, ``drivers/<kind>.py``
with ``run(cell, device, t_start)``: ``train.py`` (closed-loop LoRA
training steps). A mix's file names its kind; the generator reads every
other parameter from it."""
