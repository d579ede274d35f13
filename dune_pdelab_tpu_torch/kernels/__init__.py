"""Hand-written Hopper kernels: wrappers, launch counters, plain versions.

Importing builds nothing; the CUDA library is compiled at the first launch
on a CUDA tensor (kernels/_build.py).
"""
