"""The benchmark's plain reference: its own scene builder (``scene``), path
tracer with an exact float64 search (``trace``) and one module for each
estimator, named as the configuration names it (``naive``). Plain PyTorch
and NumPy; it imports nothing of the program it judges."""
