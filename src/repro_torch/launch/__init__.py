"""Launch layer: the prefill/decode step factories and the
continuous-batching serving engine."""
