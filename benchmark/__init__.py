"""The benchmark of the PyTorch and CUDA port, ``instancerefer_tpu_torch``: see ``run.py``."""
