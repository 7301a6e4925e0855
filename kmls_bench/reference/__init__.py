"""The plain reference the benchmark holds the port against.

Plain PyTorch and NumPy only: nothing here imports the port
(``kmlserver_tpu_torch``), the JAX package or JAX, and nothing takes a
table, a weight or a key the program made. Each module works out the
program's answer again from the inputs the benchmark drew.
"""
