"""Node-to-node plumbing (counterpart of pilosa_tpu/cluster); only the
HTTP client of one node's public API so far."""
