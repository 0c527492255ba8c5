"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin.  ``tm_popcount`` (csrc/tm_popcount.cu) is the main-path kernel;
``tm_interp`` holds only the shared host-side operand flattening so far.
``_build`` compiles ``csrc/*.cu`` with nvcc at first use."""
