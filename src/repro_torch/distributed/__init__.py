"""Distributed-training runtime pieces: the elastic runtime and the
group-bounded commit scheduler (``elastic``), and gradient compression with
error feedback (``compression``)."""
