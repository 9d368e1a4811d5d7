"""Micro-benchmarks of the port's kernels, run as modules:

    python -m echorenderer_tpu_torch.benchmarks.plucker_micro [--n-log2 20] [--device cpu]
"""
