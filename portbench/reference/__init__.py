"""Plain PyTorch reference of the benchmark's check: imports torch and numpy
only, nothing of the program, and takes nothing the program made but what
it judges (see ``lsp.py``)."""
