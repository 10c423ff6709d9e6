"""The model zoo's serving path on PyTorch: configs, layers, attention,
Mamba2 and the stage-based transformer assembly."""
