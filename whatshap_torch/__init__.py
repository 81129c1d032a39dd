"""
whatshap_torch: the PyTorch/CUDA port of whatshap_tpu.

Read-based phasing by exact weighted Minimum Error Correction.  The host
data model and packing are plain Python/numpy; the column DP runs in
hand-written CUDA kernels for Hopper (ops/wmec_cuda.py, csrc/) on a CUDA
device, and in a plain torch mirror of the same arithmetic on the CPU.
Entry points run on the GPU unless the caller passes device="cpu".  The
package imports torch, never jax, and nothing of whatshap_tpu, which stays
as the reference this port is tested against.
"""
