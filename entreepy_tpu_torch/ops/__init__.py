"""Device ops of the port: decode (decode8), encode (encode, bitpack) and the
CUDA kernel wrappers with their plain PyTorch versions (cuda_*)."""
