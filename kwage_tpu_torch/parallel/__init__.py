"""The database-construction scheduler of the port: the shared Maestro
scheduler of kwage_tpu with the device ingest and pack on this package's
kernels."""
