"""The port's command-line programs: ``python -m instancerefer_tpu_torch.scripts.train``
and ``python -m instancerefer_tpu_torch.scripts.eval``."""
