"""The distributed LAG trainer (port of ``repro.dist``)."""
