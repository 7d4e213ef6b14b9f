"""Dense llama-family model in plain PyTorch (port of ``repro.models``)."""
