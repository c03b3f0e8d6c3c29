"""Host-side runtime pieces the port keeps its own copy of: the typed
wire codec and RPC fault injection."""
