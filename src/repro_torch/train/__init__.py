"""Training: AdamW, the train/prefill steps, checkpoints and the runner."""
