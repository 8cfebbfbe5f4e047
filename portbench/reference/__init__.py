"""Plain reference of what the benchmark's cells compute, in plain PyTorch:
the CSR from the edge tuples, connected components, BFS with shortest-path
counts, a lower bound of the vertex diameter, and KADABRA's preprocessing,
sampling, frame strategies and stopping rule.  It imports neither ``jax`` nor ``repro`` nor ``repro_torch``, and
takes nothing the port made."""
