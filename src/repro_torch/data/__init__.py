"""Deterministic synthetic data (port of ``repro.data``)."""
from repro_torch.data.pipeline import (TokenStream, make_heterogeneous_inputs,
                                       make_inputs)

__all__ = ["TokenStream", "make_inputs", "make_heterogeneous_inputs"]
