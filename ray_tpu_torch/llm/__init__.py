"""Serving stack of the port: sampling, model runner, engine, server."""
