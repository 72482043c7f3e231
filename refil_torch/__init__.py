"""refil_torch: the PyTorch + CUDA (Hopper) port of refil_tpu.

The JAX package ``refil_tpu`` stays the reference; every module here mirrors
its counterpart's name and semantics and is held against it by the
``tests/test_torch_*.py`` parity tests. The masked entity attention runs as a
hand-written CUDA kernel (``csrc/entity_attn.cu``) on CUDA tensors and as its
plain PyTorch version on CPU tensors.
"""
