"""The benchmark of the PyTorch/CUDA port (``repro_torch``): its one
command is ``run.py``; ``README.md`` says how it finds a cell's pieces."""
