"""Labels, augmentation, the batch pipeline and synthetic data."""
