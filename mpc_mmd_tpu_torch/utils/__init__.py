"""Store and observability helpers of the PyTorch port."""
