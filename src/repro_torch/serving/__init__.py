"""Serving steps: prefill and batched decode on one device."""
