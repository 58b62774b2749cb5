"""Model families of the PyTorch port: pendcart, LTI and the quadrotor."""
