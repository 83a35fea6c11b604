"""Launch drivers of the LM stack (``python -m
repro_torch.launch.serve_lm`` and ``python -m repro_torch.launch.train``)."""
