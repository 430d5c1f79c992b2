"""PyTorch/CUDA port of network_distributed_pytorch_tpu.

Data-parallel training with exact all-reduce and PowerSGD-compressed
gradient sync over ``torch.distributed``, with the PowerSGD Gram-Schmidt
written as a CUDA kernel for Hopper (``csrc/gram_schmidt.cu``). The JAX
package beside it is the reference this port is held against; the port
imports nothing of it.
"""
