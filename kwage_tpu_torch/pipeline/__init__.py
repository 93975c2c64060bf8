"""End-to-end flows of the port: the .db pack through the device transpose
and the device Bloom filter build."""
