"""Observability: the metrics registry and the NVFP4 quantization-health probe."""
