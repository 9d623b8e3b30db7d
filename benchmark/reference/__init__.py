"""Plain float32 reference of the benchmark's decoder models, and its
lower-precision control."""
