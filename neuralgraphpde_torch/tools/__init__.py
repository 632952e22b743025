"""Measurement scripts for the port on a GPU (run as ``python -m
neuralgraphpde_torch.tools.<name>``): ``profile_vmh`` (device time of the
fused edge-MLP kernels and of a VMH training epoch) and ``time_build``
(the kernel build, one nvcc per source against one nvcc for all)."""
