"""The models of the dense, lattn, rec and ssd layer kinds in plain
PyTorch (port of ``repro.models``)."""
