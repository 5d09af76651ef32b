"""The benchmark of the PyTorch and CUDA port (`skge_torch`): see run.py."""
