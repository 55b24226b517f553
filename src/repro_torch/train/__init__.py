"""Training: AdamW, gradient compression and the train loop."""
