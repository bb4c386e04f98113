"""cityflow_tpu_torch: the CityFlow ring simulator in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package `cityflow_tpu`, slice by slice; this package
imports nothing of it. The host compiler (roadnet/flow JSON -> numpy
tables) is a copy; the ring step is core/ring.py; the kernels are under
csrc/ with their wrappers and plain PyTorch versions in kernels/.
"""
