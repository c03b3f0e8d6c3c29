"""Small host utilities of the port (request trace identity)."""
