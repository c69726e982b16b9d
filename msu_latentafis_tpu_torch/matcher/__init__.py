"""Dense 1:N matcher: engine, plain modules and the Hopper kernels."""
