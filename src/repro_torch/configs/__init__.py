"""Architecture configs, one module per architecture (copies of the JAX package's ``repro.configs``, data only).
Each module exposes ``CONFIG``."""
