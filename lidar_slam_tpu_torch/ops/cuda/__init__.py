"""Hand-written Hopper kernels (sources in ../../csrc), each with its plain
PyTorch version beside it. Importing builds nothing: a kernel is compiled
by nvcc the first time a CUDA tensor reaches its wrapper."""
