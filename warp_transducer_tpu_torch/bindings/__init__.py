"""Framework bindings: ``torch_binding``, the ``warprnnt_pytorch`` surface on
CPU and CUDA tensors."""
