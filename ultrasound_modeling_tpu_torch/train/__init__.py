"""Losses, metrics, the optimizer, the train step and the Trainer."""
