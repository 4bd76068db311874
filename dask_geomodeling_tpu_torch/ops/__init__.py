"""Device operations: the warp, the plain stencils and the CUDA kernels."""
