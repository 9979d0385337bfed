"""Models of the port: the transformer and the weight bridge."""
