"""Step building blocks and kernels of the PyTorch port."""
