"""Device compute of the port: the bit transpose and the search reductions."""
