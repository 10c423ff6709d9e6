"""Training: AdamW, int8 error-feedback gradient mean, the train step."""
