"""Plain PyTorch references of the benchmark's apps.

They import torch and each other only: nothing of the program under test,
and neither JAX nor the JAX package.  The benchmark hands them the same
inputs it hands the program, and they read the program's outputs only to
judge them.
"""
