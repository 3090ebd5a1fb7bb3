"""Model definitions of the port (Llama family)."""
