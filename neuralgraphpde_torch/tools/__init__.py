"""Measurement scripts for the port on a GPU (run as ``python -m
neuralgraphpde_torch.tools.<name>``): ``profile_paths`` (device time of
the training kernels and of the GRAND, VMH and GNO paths: busy and idle
share, kernel counts, peak memory, the largest device items) and
``time_build`` (the kernel build, one nvcc per source against one nvcc for
all)."""
