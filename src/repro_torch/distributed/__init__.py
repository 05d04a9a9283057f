"""Fault tolerance around the training loop (``repro/distributed``)."""
