"""Model configurations (the registry of published hyper-parameters)."""
