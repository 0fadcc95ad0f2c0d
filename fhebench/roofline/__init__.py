"""The yardstick of the kernels: peaks and each kernel's work function."""
