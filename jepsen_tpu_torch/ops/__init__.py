"""Device primitives: segment ops, the forward-fill and segmented-OR
kernels, and the cycle sweep."""
