"""Measurement entry points of the port, run as
``python3 -m matrix_fhe_tpu_torch.scripts.<name>`` on a CUDA device."""
