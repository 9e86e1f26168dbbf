"""The benchmark of ddsp_torch on NVIDIA GPUs (see README.md)."""
