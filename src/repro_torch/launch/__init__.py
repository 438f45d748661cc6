"""Launch layer: the train/prefill/decode step factories, the training
loop (``python -m repro_torch.launch.train``) and the continuous-batching
serving engine."""
