"""The plain reference of the benchmark: PyTorch and NumPy only.

Frozen copies of the port's plain renderers, heads, encoder, physics and
scene builders, written from the same formulas, and a plain Adam. Nothing
here imports the port, JAX or the JAX package, and nothing takes a table
the port made: the harness hands both sides the same inputs (scenes,
cameras, time steps, targets) and the reference works out everything else.
"""
