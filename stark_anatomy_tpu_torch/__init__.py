"""stark_anatomy_tpu_torch: the PyTorch and CUDA port of stark_anatomy_tpu.

The same field (p = 1 + 407*2^119, Montgomery R = 2^128), transcript
codec, commitments and proof bytes as the JAX package, which stays the
reference.  The field kernels are CUDA C++ for Hopper (csrc/field.cu);
entry points such as ``models.rpsss.FastRPSSS`` run on the card unless
the caller passes ``device="cpu"``.
"""
