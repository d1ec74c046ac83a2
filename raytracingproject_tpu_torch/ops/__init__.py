"""Device operations of the port: the RNG specification (rng.py) and the
hand-written CUDA kernels with their plain PyTorch versions (cuda/)."""
