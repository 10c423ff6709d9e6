"""SCOPe-managed checkpoints of the training state."""
