"""SriRachA per-read confirmation search on the device (PyTorch + CUDA port
of kwage_tpu/sriracha/device.py and of the device branch of
kwage_tpu/sriracha/engine.py). The host engine, the read sources and the
output format are ``kwage_tpu.sriracha.engine``'s, imported by module
path; this package never imports jax."""
