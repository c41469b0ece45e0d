"""Device-side ops: window attention primitives, affine crops, decode."""
