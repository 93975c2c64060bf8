"""The database-construction scheduler of the port (``maestro``)."""
