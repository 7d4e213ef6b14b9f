"""The models of the dense block kind in plain PyTorch (port of
``repro.models``)."""
