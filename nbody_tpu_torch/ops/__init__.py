"""Force kernels, their plain PyTorch twins, and the integrator.

Every hand-written CUDA kernel (``csrc/*.cu``) has a wrapper here with a
``launches`` counter and a plain twin in the same module; the wrapper runs
the twin only for CPU tensors.
"""
