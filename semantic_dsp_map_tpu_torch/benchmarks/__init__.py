"""Primitive-op probes of the port for one CUDA card (run with ``python -m``)."""
