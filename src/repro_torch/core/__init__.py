"""Core LAG primitives and JAX-ordered pytrees (port of ``repro.core``)."""
