"""Model definitions of the port (Llama-3 family)."""
