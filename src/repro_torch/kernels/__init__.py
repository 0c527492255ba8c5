"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin: ``tm_popcount`` (the served main path), ``tm_interp`` (the plan
interpreter), ``clause_eval`` (dense bitpacked clauses; also the clause
words of training), ``clause_matmul`` (clauses as an int8 tensor-core
product), ``tm_train`` (the fused training step, threefry in the
kernel), ``interp_stream`` (the paper's stream interpreter),
``clause_table`` (the class sums of a sharded tile's clause-major
table) and ``pack_literals`` (the served feature block packed to literal
words).  ``_build`` compiles ``csrc/*.cu`` with nvcc at first use."""
