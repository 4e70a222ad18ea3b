"""repro_torch — the fusion compiler for BLAS sequences (Filipovič et al.,
2013) in PyTorch and CUDA for NVIDIA Hopper.

Trace a sequence of elementary calls, search the legal fusions with the
cost model, plan, and run each fused group as one generated CUDA kernel
(``core.cuda_codegen``) or as plain torch code.  The subpackages mirror
the JAX reference package ``repro`` module for module; this package
imports neither JAX nor ``repro``.
"""
