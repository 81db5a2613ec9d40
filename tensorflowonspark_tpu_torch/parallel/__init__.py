"""Training on the card: the train step and the fused K-step loop."""
