"""The deterministic synthetic data pipeline (``pipeline``) and its numpy
copy of jax's threefry random numbers (``_threefry``)."""
