"""The plain reference that decides ``correct``: the scene's Poisson
likelihood, its Fisher metrics, the trajectories, the trans-dimensional
moves and the two heads' steps (one ChEES iteration, one SMC temperature
step), in plain PyTorch at whatever dtype the inputs have (float64 for the
reference, bfloat16 for the control).

It is a frozen copy of the plain path of the PyTorch port as it stood
when the benchmark was written, written out again so that it imports
nothing of the program (neither the port nor the JAX package): later
changes to the program cannot move it.  It takes only the inputs the
benchmark made (the image, the draws) and the program's state before a
step, and works out everything else again.
"""
