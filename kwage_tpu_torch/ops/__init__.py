"""Device compute of the port: canonical k-mers, murmur, counting and
filter bits, the bit transpose and the search reductions."""
