"""Tensor ops of the port: layers and the K1 flash-attention wrapper."""
