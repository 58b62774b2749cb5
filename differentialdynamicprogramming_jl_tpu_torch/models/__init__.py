"""Model families of the PyTorch port (this slice: the pendcart lane model)."""
