"""PyTorch/CUDA port of the Datalog-for-ML stack (see ``repro`` for the JAX
reference).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``."""
