"""HTTP server of one node: the wire codec, the handler and the server
assembly (counterpart of pilosa_tpu/server)."""
