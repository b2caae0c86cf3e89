"""Native code: host setup kernels (C++) and CUDA solve kernels."""
