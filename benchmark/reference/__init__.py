"""The plain reference the benchmark holds the program's outputs against:
frozen copies of the port's plain PyTorch pieces (each file names its
source) and ``system.py``, which composes them.  Imports nothing of the
program."""
