"""Serving tier: the Predictor (full-graph and precomputed backends),
propagation tables, quantized tables, the export artifact, the
microbatch Server and typed errors."""
