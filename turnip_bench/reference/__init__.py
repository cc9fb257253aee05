"""The plain float32 reference of each benchmarked family
(``<family>.py``) and their shared parts (``common.py``): plain torch,
nothing of the program."""
