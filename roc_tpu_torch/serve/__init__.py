"""Serving tier: full-graph Predictor, microbatch Server, typed errors."""
