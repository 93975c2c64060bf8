"""Device-resident search serving of the port."""
