"""Host-side transport of the port: the raw-frame layer of the KV stream."""
