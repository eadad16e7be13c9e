"""Plain PyTorch reference of what the timed paths compute.

Imports torch and numpy only: nothing of the program under test and
nothing of JAX. Every function is a frozen copy, in plain tensor
operations, of the published recipe the program implements (GCC,
arXiv 2006.09963), with the program's documented choices (the subspace
PE's schedule, the Jacobi finish, the masked BatchNorm) written out.
"""
