"""Process-environment helpers of the port (device selection)."""
