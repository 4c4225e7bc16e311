"""Roofline analysis of the dry run's steps (``roofline``)."""
