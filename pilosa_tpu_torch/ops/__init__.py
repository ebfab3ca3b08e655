"""Device compute: bitwise algebra and the count kernels."""
