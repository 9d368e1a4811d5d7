"""The plain reference of the benchmark: a path tracer in plain PyTorch
and numpy that imports nothing of the program (tracer.py)."""
