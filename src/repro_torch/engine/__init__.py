"""The shared LAG round and server optimizers (port of ``repro.engine``)."""
