"""Serving: the HTTP InferenceServer, evaluation and the brain->bleed
cascade, int8 weight-only serving, export, rendering."""
