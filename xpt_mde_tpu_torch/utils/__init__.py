"""SE(3) pose math, image helpers and float32 precision control."""
