"""NVFP4 numerics: formats, quantizers, schemes and the quantized linear."""
