"""The train, prefill and decode step functions (``steps``)."""
